"""Zero-dependency metrics registry: counters, gauges, log-bucket
histograms, JSONL snapshots.

The paper evaluates Planter on *measured* latency/throughput/resource
numbers (§7); this registry is the repo's equivalent of the switch
counters those measurements came from.  Design constraints:

* **zero dependencies** — stdlib + numpy only (the container has no
  prometheus_client et al., and the serve hot path must not import
  anything heavier than it already does);
* **fixed log-spaced buckets** — every :class:`Histogram` with the same
  ``(lo, hi, per_decade)`` geometry has byte-identical bucket edges, so
  snapshots from different shards/processes merge by adding counts
  (the same reason Planter fixes its table layouts up front: a shared
  quantization grid makes aggregation exact);
* **snapshot, don't stream** — :meth:`Metrics.snapshot` is a plain dict
  and :meth:`Metrics.write_jsonl` appends one line per call, so a
  long-running trainer emits a time series and a bench emits one line,
  with the same code.

Nothing here touches JAX: instruments are plain Python mutations, cheap
enough to live on the host side of a ``sync_every`` drain.
"""
from __future__ import annotations

import json
import math
import time
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "Metrics"]


class Counter:
    """Monotonic count (requests served, pages COW'd, rebalances)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += n


class Gauge:
    """Last-write-wins level (queue depth, free pages, loss)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed log-spaced buckets: edge ``i`` is ``lo * 10**(i/per_decade)``.

    The geometry is fixed at construction (never grown to fit data), so
    two histograms with the same ``(lo, hi, per_decade)`` are mergeable
    by adding their count arrays — cross-shard aggregation stays exact.
    Values below ``lo`` land in an underflow bucket, values at or above
    the top edge in an overflow bucket.  Default geometry covers 1 µs to
    100 s in milliseconds at 4 buckets per decade (32 buckets) — wide
    enough for a fused-step TTFT and a CUDA graph capture alike.
    """

    __slots__ = ("edges", "counts", "count", "sum", "min", "max",
                 "_lo", "_per_over_span")

    def __init__(self, lo: float = 1e-3, hi: float = 1e5,
                 per_decade: int = 4):
        if lo <= 0 or hi <= lo:
            raise ValueError("need 0 < lo < hi for log-spaced buckets")
        n = int(math.ceil(per_decade * math.log10(hi / lo)))
        self.edges: List[float] = [lo * 10 ** (i / per_decade)
                                   for i in range(n + 1)]
        # counts[0] = underflow, counts[i+1] = [edges[i], edges[i+1]),
        # counts[-1] = overflow
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        # observe() runs per drained request on the serve path: bucket
        # inversion is one log10 + one multiply
        self._lo = self.edges[0]
        self._per_over_span = (len(self.edges) - 1) / math.log10(
            self.edges[-1] / self._lo)

    def _bucket(self, v: float) -> int:
        if v < self.edges[0]:
            return 0
        if v >= self.edges[-1]:
            return len(self.counts) - 1
        # log-spaced edges invert in O(1); clamp kills float fuzz at
        # exact edges (an edge value belongs to the bucket it opens)
        per = len(self.edges) - 1
        i = int(math.log10(v / self._lo) * self._per_over_span)
        i = max(0, min(i, per - 1))
        while i > 0 and v < self.edges[i]:
            i -= 1
        while i < per - 1 and v >= self.edges[i + 1]:
            i += 1
        return i + 1

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-interpolated percentile (``q`` in [0, 100]).

        Underflow reports the bottom edge and overflow the recorded
        max — a log histogram cannot interpolate past its geometry.
        """
        if self.count == 0:
            return None
        target = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                frac = (target - seen) / c
                if i == 0:
                    return self.edges[0]
                if i == len(self.counts) - 1:
                    return self.max
                lo, hi = self.edges[i - 1], self.edges[i]
                return lo + frac * (hi - lo)
            seen += c
        return self.max

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s observations in (exact: the fixed geometry
        means bucket counts simply add).  Geometries must match."""
        if self.edges != other.edges:
            raise ValueError("histogram geometries differ; merge would "
                             "re-bucket and stop being exact")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        for v in (other.min,):
            if v is not None:
                self.min = v if self.min is None else min(self.min, v)
        for v in (other.max,):
            if v is not None:
                self.max = v if self.max is None else max(self.max, v)
        return self

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "edges": self.edges,
            "counts": list(self.counts),
        }


class Metrics:
    """Name-keyed instrument registry with JSONL snapshot export."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # ------------------------------------------------------- instruments
    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, **kw) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(**kw)
        return h

    def reset(self) -> None:
        """Zero every instrument in place (bench: call after warmup so
        compile-time outliers never pollute steady-state percentiles).
        In place, not cleared: cached instrument handles (the Tracer's,
        the page pool's) stay live across resets."""
        for c in self._counters.values():
            c.value = 0
        for g in self._gauges.values():
            g.value = None
        for h in self._hists.values():
            h.counts = [0] * len(h.counts)
            h.count = 0
            h.sum = 0.0
            h.min = h.max = None

    def merge(self, other: "Metrics") -> "Metrics":
        """Fold another registry in (cross-shard/process aggregation):
        counters add, gauges last-write-wins (``other`` wins when set),
        histograms merge exactly via their shared bucket geometry."""
        for k, c in other._counters.items():
            self.counter(k).value += c.value
        for k, g in other._gauges.items():
            if g.value is not None:
                self.gauge(k).set(g.value)
        for k, h in other._hists.items():
            mine = self._hists.get(k)
            if mine is None:
                mine = self._hists[k] = Histogram()
                if mine.edges != h.edges:  # non-default geometry source
                    mine.edges = list(h.edges)
                    mine.counts = [0] * (len(h.edges) + 1)
                    mine._lo = mine.edges[0]
                    mine._per_over_span = (len(mine.edges) - 1) / math.log10(
                        mine.edges[-1] / mine._lo)
            mine.merge(h)
        return self

    # --------------------------------------------------------- snapshots
    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(
                self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.to_dict() for k, h in sorted(
                self._hists.items())},
        }

    def write_jsonl(self, path: str, **extra) -> None:
        """Append one snapshot line (``extra`` keys ride along — step
        number, scenario tag, wall time)."""
        line = {"t": time.time(), **extra, **self.snapshot()}
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")
