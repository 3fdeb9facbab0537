"""Request-lifecycle tracing for the serve/train stacks.

A request moves submitted -> admitted -> prefilling -> decoding ->
drained (or ends in a drop).  :class:`Tracer` records those transitions
as events carrying BOTH clocks the repo has:

* **host wall-clock** — ``time.perf_counter`` (the same monotonic source
  the batchers' ``done_at`` uses, so drain timestamps and trace spans
  can never disagree about ordering);
* **device step counter** — the fused serve step's own step count.  The
  device batcher runs ``sync_every`` steps per host round trip, so
  per-event host timestamps inside a round trip are *interpolated*
  between the observed (step, wall-clock) sync boundaries — exact at
  boundaries, linear in between, monotone always.

From the per-request event record the tracer derives:

* **phase spans** — ``queued`` (submit -> admit), ``prefill`` (admit ->
  first token), ``decode`` (first token -> done), ``drained`` (done ->
  host drain);
* **phase latency percentiles** — TTFT, queue wait, per-token decode
  (fed into :class:`obs.metrics.Metrics` histograms when one is
  attached);
* **Chrome trace-event JSON** — ``{"traceEvents": [...]}`` loadable in
  ``chrome://tracing`` / Perfetto: one complete ("X") event per phase
  span, instant ("i") events for drops/rebalances, thread-name metadata
  per shard.

Invariants (pinned by ``tests/test_torch_obs.py``):

* a request has **exactly one terminal** event (finished or dropped) —
  a second terminal raises;
* ``submitted`` keeps the *earliest* timestamp (the router stamps at
  submit; the shard batcher's re-stamp at hand-off must not erase the
  queue-wait the request already paid);
* per request, ordering by device step equals ordering by host time
  (monotone interpolation), and phase spans never have negative length.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

from .metrics import Metrics

__all__ = ["RequestTrace", "Tracer", "step_time_interp"]

TERMINAL_DONE = "done"
TERMINAL_DROP = "drop"


def step_time_interp(boundaries: List[tuple]):
    """Piecewise-linear step -> host-time map from ``(step, t)`` sync
    boundaries (both coordinates non-decreasing).  Returns a callable;
    steps outside the observed range clamp to the nearest boundary, so
    interpolated times are always inside the run's wall-clock window."""
    if not boundaries:
        raise ValueError("need at least one (step, time) boundary")
    steps = [s for s, _ in boundaries]
    times = [t for _, t in boundaries]

    def interp(step: float) -> float:
        if step <= steps[0]:
            return times[0]
        for (s0, t0), (s1, t1) in zip(boundaries, boundaries[1:]):
            if step <= s1:
                if s1 == s0:
                    return t1
                return t0 + (step - s0) / (s1 - s0) * (t1 - t0)
        return times[-1]

    return interp


@dataclasses.dataclass(slots=True)
class RequestTrace:
    """One request's lifecycle: event times on both clocks."""
    rid: Any
    shard: int = 0
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    t_drain: Optional[float] = None
    step_admit: Optional[int] = None
    step_first: Optional[int] = None
    step_done: Optional[int] = None
    n_tokens: int = 0
    terminal: Optional[str] = None  # "done" | "drop"
    drop_reason: Optional[str] = None
    retries: int = 0    # queue-full backoff re-attempts
    failovers: int = 0  # shard-failure re-routes (replayed from prompt)

    # ------------------------------------------------------------ derived
    def phase_spans(self) -> List[tuple]:
        """(name, t0, t1) for every phase with both endpoints known."""
        spans = []
        for name, a, b in (("queued", self.t_submit, self.t_admit),
                           ("prefill", self.t_admit, self.t_first),
                           ("decode", self.t_first, self.t_done),
                           ("drained", self.t_done, self.t_drain)):
            if a is not None and b is not None:
                spans.append((name, a, b))
        return spans

    def queue_wait_ms(self) -> Optional[float]:
        if self.t_submit is None or self.t_admit is None:
            return None
        return (self.t_admit - self.t_submit) * 1e3

    def ttft_ms(self) -> Optional[float]:
        """Submit -> first generated token (the user-visible latency)."""
        if self.t_submit is None or self.t_first is None:
            return None
        return (self.t_first - self.t_submit) * 1e3

    def decode_ms_per_token(self) -> Optional[float]:
        if self.t_first is None or self.t_done is None or self.n_tokens < 2:
            return None
        return (self.t_done - self.t_first) * 1e3 / (self.n_tokens - 1)


class Tracer:
    """Collects request lifecycles + freeform spans; exports Chrome JSON.

    Hot-path cost is one dict update per *event* (host side only); the
    device batcher batches its events into per-run array drains, so the
    fused loop never crosses to host for tracing — and defers even the
    per-request host emission via :meth:`defer`, so the serve loop pays
    a single list append per drain and the event materialization runs
    at export time (first read of requests / percentiles / chrome
    trace).  Attach a :class:`Metrics` registry and every completed
    request feeds the ``serve.{queue_wait,ttft,decode_per_token}_ms``
    histograms.
    """

    def __init__(self, metrics: Optional[Metrics] = None,
                 clock=time.perf_counter):
        self._metrics: Optional[Metrics] = None
        self.clock = clock
        self._requests: Dict[Any, RequestTrace] = {}
        self._pending: List[Any] = []  # deferred emission thunks (FIFO)
        self.spans: List[dict] = []    # freeform chrome "X" events
        self.instants: List[dict] = []  # chrome "i" events
        self.epoch = clock()  # trace time zero (chrome ts are relative)
        self.metrics = metrics  # property: caches instrument handles

    @property
    def requests(self) -> Dict[Any, RequestTrace]:
        self.flush()
        return self._requests

    @property
    def metrics(self) -> Optional[Metrics]:
        return self._metrics

    @metrics.setter
    def metrics(self, m: Optional[Metrics]) -> None:
        # cache instrument handles once: terminal events on the drain
        # path then cost attribute calls only, no registry lookups
        # (safe because Metrics.reset() zeroes in place)
        self._metrics = m
        if m is not None:
            self._c_done = m.counter("serve.requests_done")
            self._c_tok = m.counter("serve.tokens_generated")
            self._c_drop = m.counter("serve.requests_dropped")
            self._h_wait = m.histogram("serve.queue_wait_ms")
            self._h_ttft = m.histogram("serve.ttft_ms")
            self._h_dec = m.histogram("serve.decode_ms_per_token")
            self._c_retry = m.counter("serve.requests_retried")
            self._c_fail = m.counter("serve.requests_failed_over")

    def reset(self) -> None:
        """Drop recorded data, keep the epoch (bench: call after warmup
        so compile-time outliers never pollute steady-state stats).
        Unflushed deferred emission is dropped with it."""
        self._pending.clear()
        self._requests.clear()
        self.spans.clear()
        self.instants.clear()

    # --------------------------------------------------- deferred emission
    def defer(self, fn) -> None:
        """Queue an emission thunk to run at first read.  The device
        batcher drains a whole run's lifecycle events at once; deferring
        them keeps the serve loop's tracing cost to one list append and
        moves the per-request dict/histogram work to export time."""
        self._pending.append(fn)

    def flush(self) -> None:
        """Run queued emission thunks in FIFO order (idempotent)."""
        while self._pending:
            fn = self._pending.pop(0)
            fn()

    # ------------------------------------------------------ request events
    def _req(self, rid) -> RequestTrace:
        r = self._requests.get(rid)
        if r is None:
            r = self._requests[rid] = RequestTrace(rid)
        return r

    def submitted(self, rid, t: Optional[float] = None) -> None:
        r = self._req(rid)
        t = self.clock() if t is None else t
        # earliest wins: the router stamps first, the shard batcher's
        # hand-off re-stamp must not erase queue time already paid
        if r.t_submit is None or t < r.t_submit:
            r.t_submit = t

    def admitted(self, rid, t: Optional[float] = None,
                 step: Optional[int] = None, shard: int = 0) -> None:
        r = self._req(rid)
        r.t_admit = self.clock() if t is None else t
        r.step_admit = step
        r.shard = shard

    def first_token(self, rid, t: Optional[float] = None,
                    step: Optional[int] = None) -> None:
        r = self._req(rid)
        r.t_first = self.clock() if t is None else t
        r.step_first = step

    def _terminal(self, r: RequestTrace, kind: str) -> None:
        if r.terminal is not None:
            raise ValueError(
                f"request {r.rid!r} already terminal ({r.terminal}); "
                f"second terminal event {kind} — lifecycle bug")
        r.terminal = kind

    def finished(self, rid, n_tokens: int = 0, t: Optional[float] = None,
                 step: Optional[int] = None) -> None:
        r = self._req(rid)
        self._terminal(r, TERMINAL_DONE)
        r.t_done = self.clock() if t is None else t
        r.step_done = step
        r.n_tokens = int(n_tokens)
        if self._metrics is not None:
            self._c_done.inc()
            self._c_tok.inc(r.n_tokens)
            v = r.queue_wait_ms()
            if v is not None:
                self._h_wait.observe(v)
            v = r.ttft_ms()
            if v is not None:
                self._h_ttft.observe(v)
            v = r.decode_ms_per_token()
            if v is not None:
                self._h_dec.observe(v)

    def drained(self, rid, t: Optional[float] = None) -> None:
        """Host observed the finished request (the sync_every round trip
        that surfaced it — the same instant ``done_at`` records)."""
        r = self._req(rid)
        r.t_drain = self.clock() if t is None else t

    def dropped(self, rid, reason: str, t: Optional[float] = None,
                step: Optional[int] = None) -> None:
        r = self._req(rid)
        self._terminal(r, TERMINAL_DROP)
        r.t_done = self.clock() if t is None else t
        r.step_done = step
        r.drop_reason = reason
        if self._metrics is not None:
            self._c_drop.inc()
            self._metrics.counter(f"serve.drop.{reason}").inc()

    # ------------------------------------------------- failure transitions
    def retried(self, rid, attempt: int = 1, t: Optional[float] = None,
                shard: int = 0) -> None:
        """Queue-full backoff re-attempt landed the request back in the
        queue (NOT terminal — the request is alive again)."""
        r = self._req(rid)
        r.retries += 1
        t = self.clock() if t is None else t
        self.instant("retried", t=t, tid=shard, rid=repr(rid),
                     attempt=attempt)
        if self._metrics is not None:
            self._c_retry.inc()

    def failed_over(self, rid, frm: int, to: int,
                    t: Optional[float] = None) -> None:
        """A dead shard's request was re-routed (replayed from its
        prompt) to a survivor — lifecycle continues on the new shard."""
        r = self._req(rid)
        r.failovers += 1
        t = self.clock() if t is None else t
        self.instant("failed-over", t=t, tid=to, rid=repr(rid),
                     frm=frm, to=to)
        if self._metrics is not None:
            self._c_fail.inc()

    def deadline_dropped(self, rid, t: Optional[float] = None,
                         step: Optional[int] = None, shard: int = 0) -> None:
        """Deadline exceeded: the slot/queue entry was evicted.  Terminal
        (a ``deadline`` drop) plus a visible instant for the timeline."""
        t = self.clock() if t is None else t
        self.instant("deadline-dropped", t=t, tid=shard, rid=repr(rid))
        self.dropped(rid, "deadline", t=t, step=step)

    def quarantined(self, rid, t: Optional[float] = None,
                    step: Optional[int] = None, shard: int = 0) -> None:
        """Poisoned sample detected: exactly this slot was evicted.
        Terminal (a ``quarantined`` drop) plus a timeline instant."""
        t = self.clock() if t is None else t
        self.instant("quarantined", t=t, tid=shard, rid=repr(rid))
        self.dropped(rid, "quarantined", t=t, step=step)

    # ----------------------------------------------------- freeform events
    def span(self, name: str, t0: float, t1: float, tid: int = 0,
             **args) -> None:
        """Record a generic complete span (train steps, bench phases)."""
        self.spans.append({"name": name, "t0": t0, "t1": t1, "tid": tid,
                           "args": args})

    def instant(self, name: str, t: Optional[float] = None, tid: int = 0,
                **args) -> None:
        self.instants.append({"name": name,
                              "t": self.clock() if t is None else t,
                              "tid": tid, "args": args})

    # ----------------------------------------------------------- summaries
    def phase_latencies(self) -> Dict[str, List[float]]:
        out: Dict[str, List[float]] = {"queue_wait_ms": [], "ttft_ms": [],
                                       "decode_ms_per_token": []}
        for r in self.requests.values():
            for name, v in (("queue_wait_ms", r.queue_wait_ms()),
                            ("ttft_ms", r.ttft_ms()),
                            ("decode_ms_per_token",
                             r.decode_ms_per_token())):
                if v is not None:
                    out[name].append(v)
        return out

    def phase_percentiles(self) -> Dict[str, dict]:
        """{phase: {p50, p99, mean, n}} over every completed request —
        the per-phase latency breakdown BENCH_serve.json carries."""
        import numpy as np

        out = {}
        for name, vals in self.phase_latencies().items():
            if vals:
                out[name] = {
                    "p50": float(np.percentile(vals, 50)),
                    "p99": float(np.percentile(vals, 99)),
                    "mean": float(np.mean(vals)),
                    "n": len(vals),
                }
            else:
                out[name] = {"p50": None, "p99": None, "mean": None, "n": 0}
        return out

    def validate(self) -> List[str]:
        """Lifecycle violations (empty list = clean): admitted requests
        must reach exactly one terminal, phases must be causally ordered
        on both clocks."""
        problems = []
        for r in self.requests.values():
            if r.t_admit is not None and r.terminal is None:
                problems.append(f"{r.rid!r}: admitted but never terminal")
            for name, t0, t1 in r.phase_spans():
                if t1 < t0:
                    problems.append(
                        f"{r.rid!r}: phase {name} negative ({t0}->{t1})")
            steps = [s for s in (r.step_admit, r.step_first, r.step_done)
                     if s is not None]
            if steps != sorted(steps):
                problems.append(f"{r.rid!r}: device steps out of order "
                                f"{steps}")
        return problems

    # -------------------------------------------------------- chrome trace
    def _us(self, t: float) -> float:
        return (t - self.epoch) * 1e6

    def chrome_trace(self) -> dict:
        """Trace-event JSON (``chrome://tracing`` / Perfetto): pid 0 =
        the serve/train process, tid = shard; every phase span is a
        complete ("X") event, drops and freeform instants are "i"."""
        ev: List[dict] = []
        tids = {0}
        for r in self.requests.values():
            tids.add(r.shard)
            for name, t0, t1 in r.phase_spans():
                ev.append({
                    "name": name, "ph": "X", "pid": 0, "tid": r.shard,
                    "ts": self._us(t0), "dur": max(0.0, (t1 - t0) * 1e6),
                    "cat": "request",
                    "args": {"rid": repr(r.rid), "n_tokens": r.n_tokens,
                             **({"step": r.step_done}
                                if r.step_done is not None else {})},
                })
            if r.terminal == TERMINAL_DROP and r.t_done is not None:
                ev.append({
                    "name": f"drop:{r.drop_reason}", "ph": "i", "pid": 0,
                    "tid": r.shard, "ts": self._us(r.t_done), "s": "t",
                    "cat": "drop", "args": {"rid": repr(r.rid)},
                })
        for s in self.spans:
            tids.add(s["tid"])
            ev.append({"name": s["name"], "ph": "X", "pid": 0,
                       "tid": s["tid"], "ts": self._us(s["t0"]),
                       "dur": max(0.0, (s["t1"] - s["t0"]) * 1e6),
                       "cat": "span", "args": s["args"]})
        for i in self.instants:
            tids.add(i["tid"])
            ev.append({"name": i["name"], "ph": "i", "pid": 0,
                       "tid": i["tid"], "ts": self._us(i["t"]), "s": "t",
                       "cat": "event", "args": i["args"]})
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
                 "args": {"name": f"shard-{t}"}} for t in sorted(tids)]
        return {"traceEvents": meta + sorted(ev, key=lambda e: e["ts"]),
                "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
