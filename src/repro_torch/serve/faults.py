"""Deterministic fault injection + recovery helpers for the serve stack.

The paper's deployment bar is *fail-safe coexistence*: an in-network
model that can take the switch down with it is unshippable, so the
mapped pipeline must degrade — never crash — the mandatory function.
This module is that requirement applied to the serve stack: a seeded,
replayable :class:`FaultPlan` describes shard crashes, slow shards,
corrupted samples and page-pool exhaustion, and a :class:`FaultInjector`
applies them **at host drain boundaries only**.  The jitted serve kernel
is never touched — the traced and untraced, faulted and fault-free paths
all run the same jit cache entry, so a faulted run stays bit-replayable
and the failure machinery costs nothing when no fault is active.

Fault taxonomy (all one-shot, consumed when they fire):

* :class:`ShardCrash` — the router marks the shard dead before the
  shard's ``at_drain``-th drain turn; queued AND in-flight requests fail
  over to surviving shards (``ShardedServe._fail_shard``).
* :class:`SlowShard` — adds ``delay_s`` virtual seconds to the shard's
  recorded drain time, feeding the ``StragglerMonitor`` (repeated
  violations evict the shard like a crash).
* :class:`CorruptTokens` — overwrites slot ``s``'s latest sampled token
  with an out-of-vocab sentinel at a batcher drain boundary, modelling a
  NaN/Inf logit row; the per-drain finite check quarantines exactly the
  offending slot.
* :class:`PoolExhaust` — takes a phantom reference on every free page
  for ``hold_drains`` drain boundaries, forcing FIFO admission to block
  and recover.

Drain indexing: ``ShardCrash``/``SlowShard`` count the **router's**
per-shard drain turns; ``CorruptTokens``/``PoolExhaust`` count the
target **batcher's** own drain boundaries (host step, or sync_every
round trip), both 0-based from construction.

This module must stay import-clean of ``jax`` (enforced by ruff's
banned-api check): fault injection is host-side bookkeeping by design.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "NAN_TOKEN", "INF_TOKEN", "ShardCrash", "SlowShard", "CorruptTokens",
    "PoolExhaust", "FaultPlan", "FaultInjector", "queue_to_tree",
    "tree_to_queue", "drain_unserved", "preempt_snapshot", "warm_restart",
]

# Out-of-vocab sentinels: a greedy argmax over [0, vocab) can never emit
# them, so the finite check (0 <= tok < vocab) fires iff injected — the
# host-side model of a NaN (garbage-negative) / Inf (garbage-positive)
# logit row poisoning the sample.
NAN_TOKEN = -(1 << 30)
INF_TOKEN = 1 << 30


@dataclasses.dataclass(frozen=True)
class ShardCrash:
    """Kill shard ``shard`` before its ``at_drain``-th router turn."""
    shard: int
    at_drain: int


@dataclasses.dataclass(frozen=True)
class SlowShard:
    """Add ``delay_s`` virtual seconds to one recorded drain time."""
    shard: int
    delay_s: float
    at_drain: int


@dataclasses.dataclass(frozen=True)
class CorruptTokens:
    """Poison slot ``slot``'s latest token at a batcher drain boundary."""
    slot: int
    at_drain: int
    shard: int = 0
    value: int = NAN_TOKEN


@dataclasses.dataclass(frozen=True)
class PoolExhaust:
    """Pin every free page for ``hold_drains`` batcher drain boundaries."""
    at_drain: int
    hold_drains: int = 1
    shard: int = 0


_KINDS = (ShardCrash, SlowShard, CorruptTokens, PoolExhaust)


class FaultPlan:
    """An immutable, ordered set of fault events.

    Build explicitly (``FaultPlan([ShardCrash(1, 2), ...])``), from a
    seed (:meth:`seeded` — parameters drawn deterministically, so the
    same seed replays the same failures), or from a CLI spec string
    (:meth:`parse` — the ``--fault-plan`` flag on ``launch/serve.py``).
    """

    def __init__(self, faults: Sequence[Any] = ()):
        for f in faults:
            if not isinstance(f, _KINDS):
                raise TypeError(f"not a fault event: {f!r}")
        self.faults: Tuple[Any, ...] = tuple(faults)

    def __repr__(self):
        return f"FaultPlan({list(self.faults)!r})"

    def __iter__(self):
        return iter(self.faults)

    def __len__(self):
        return len(self.faults)

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)

    @classmethod
    def seeded(cls, seed: int, *, n_shards: int = 1, n_slots: int = 8,
               crash: bool = True, nan: bool = True, slow: bool = False,
               exhaust: bool = False, max_drain: int = 2) -> "FaultPlan":
        """Draw one event per requested kind from ``seed``.

        Liveness guarantees (so a seeded plan always *fires* under a
        saturated workload): the corruption targets shard 0 and the
        crash never does, so the crash can't pre-empt the corruption;
        drains are drawn from [1, max_drain], past the first fill.
        """
        rng = random.Random(seed)
        faults: List[Any] = []
        if crash and n_shards > 1:
            faults.append(ShardCrash(
                shard=rng.randrange(1, n_shards),
                at_drain=rng.randint(1, max_drain)))
        if nan:
            faults.append(CorruptTokens(
                slot=rng.randrange(max(1, n_slots)),
                at_drain=rng.randint(1, max_drain), shard=0,
                value=rng.choice((NAN_TOKEN, INF_TOKEN))))
        if slow and n_shards > 1:
            faults.append(SlowShard(
                shard=rng.randrange(1, n_shards),
                delay_s=rng.uniform(0.5, 2.0),
                at_drain=rng.randint(1, max_drain)))
        if exhaust:
            faults.append(PoolExhaust(
                at_drain=rng.randint(1, max_drain),
                hold_drains=rng.randint(1, 2), shard=0))
        return cls(faults)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a CLI plan: comma-separated ``kind:args@drain`` events.

        * ``crash:<shard>@<drain>``
        * ``slow:<shard>:<delay_s>@<drain>``
        * ``nan:<slot>@<drain>`` / ``nan:<slot>:<shard>@<drain>``
          (``inf:`` for the positive sentinel)
        * ``exhaust@<drain>`` / ``exhaust:<shard>@<drain>`` /
          ``exhaust:<shard>:<hold_drains>@<drain>``
        * ``seed:<n>`` — shorthand for ``FaultPlan.seeded(n)`` merged in
          (``seed:<n>:<n_shards>:<n_slots>`` to size it).
        """
        faults: List[Any] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            head, _, drain_s = part.partition("@")
            bits = head.split(":")
            kind, args = bits[0], bits[1:]
            if kind == "seed":
                n_shards = int(args[1]) if len(args) > 1 else 2
                n_slots = int(args[2]) if len(args) > 2 else 8
                faults.extend(cls.seeded(int(args[0]), n_shards=n_shards,
                                         n_slots=n_slots).faults)
                continue
            if not drain_s:
                raise ValueError(f"fault event needs @<drain>: {part!r}")
            drain = int(drain_s)
            if kind == "crash":
                faults.append(ShardCrash(shard=int(args[0]), at_drain=drain))
            elif kind == "slow":
                faults.append(SlowShard(shard=int(args[0]),
                                        delay_s=float(args[1]),
                                        at_drain=drain))
            elif kind in ("nan", "inf"):
                faults.append(CorruptTokens(
                    slot=int(args[0]), at_drain=drain,
                    shard=int(args[1]) if len(args) > 1 else 0,
                    value=NAN_TOKEN if kind == "nan" else INF_TOKEN))
            elif kind == "exhaust":
                faults.append(PoolExhaust(
                    at_drain=drain,
                    shard=int(args[0]) if args else 0,
                    hold_drains=int(args[1]) if len(args) > 1 else 1))
            else:
                raise ValueError(f"unknown fault kind {kind!r} in {part!r}")
        return cls(faults)


class FaultInjector:
    """Per-run consumption state over a :class:`FaultPlan`.

    Every query is a one-shot: an event that fires is moved to
    :attr:`fired` and never fires again, so a plan applied across
    resumed ``run()`` calls injects each failure exactly once.  The
    injector is passive — batchers and the router poll it at their own
    drain boundaries; it never touches device state itself.
    """

    def __init__(self, plan: FaultPlan):
        self._pending: List[Any] = list(plan.faults)
        self.fired: List[Any] = []

    def _take(self, match: Callable[[Any], bool]) -> List[Any]:
        due = [f for f in self._pending if match(f)]
        for f in due:
            self._pending.remove(f)
            self.fired.append(f)
        return due

    # ------------------------------------------------------------ queries
    def crash_due(self, shard: int, drain: int) -> bool:
        """True once, when shard ``shard`` reaches a crash boundary."""
        return bool(self._take(
            lambda f: isinstance(f, ShardCrash) and f.shard == shard
            and f.at_drain <= drain))

    def slow_delay(self, shard: int, drain: int) -> float:
        """Virtual seconds to add to this drain's recorded wall time."""
        return sum(f.delay_s for f in self._take(
            lambda f: isinstance(f, SlowShard) and f.shard == shard
            and f.at_drain <= drain))

    def corruptions(self, shard: int, drain: int) -> List[CorruptTokens]:
        return self._take(
            lambda f: isinstance(f, CorruptTokens) and f.shard == shard
            and f.at_drain <= drain)

    def exhaustions(self, shard: int, drain: int) -> List[PoolExhaust]:
        return self._take(
            lambda f: isinstance(f, PoolExhaust) and f.shard == shard
            and f.at_drain <= drain)

    # ---------------------------------------------------------- inspection
    def pending_for(self, shard: int) -> bool:
        """Any unfired event targeting ``shard`` (batchers use this to
        keep the fault path disabled — and free — when nothing can
        fire)."""
        return any(getattr(f, "shard", None) == shard
                   for f in self._pending)

    def pending_kinds(self, shard: int, kind: type) -> List[Any]:
        return [f for f in self._pending
                if isinstance(f, kind) and getattr(f, "shard", 0) == shard]


# --------------------------------------------------------------------------
# Preemption snapshots: the un-served queue as a flat array tree that
# ``ckpt.CheckpointManager`` can save/restore (SIGTERM -> stop admitting,
# drain in-flight, snapshot, warm-restart resubmits).
# --------------------------------------------------------------------------

def queue_to_tree(entries: Sequence[tuple]) -> Dict[str, np.ndarray]:
    """Pack ``(rid, prompt, features, deadline_rem_s)`` queue entries
    into a flat dict of arrays.  Request ids must be integers (the
    launcher's are); features pad to the widest row, -1 deadline means
    none."""
    n = len(entries)
    plen = max([len(p) for _, p, _, _ in entries], default=0)
    flen = max([0 if f is None else len(f) for _, _, f, _ in entries],
               default=0)
    tree = {
        "rids": np.full(n, -1, np.int64),
        "plen": np.zeros(n, np.int32),
        "prompts": np.zeros((n, max(plen, 1)), np.int32),
        "hasf": np.zeros(n, bool),
        "feats": np.zeros((n, max(flen, 1)), np.int32),
        "deadline": np.full(n, -1.0, np.float64),
    }
    for i, (rid, prompt, feat, ddl) in enumerate(entries):
        tree["rids"][i] = int(rid)
        tree["plen"][i] = len(prompt)
        tree["prompts"][i, : len(prompt)] = prompt
        if feat is not None:
            tree["hasf"][i] = True
            tree["feats"][i, : len(feat)] = feat
        if ddl is not None:
            tree["deadline"][i] = float(ddl)
    return tree


def tree_to_queue(tree: Dict[str, np.ndarray]) -> List[tuple]:
    """Inverse of :func:`queue_to_tree`."""
    out = []
    for i in range(len(tree["rids"])):
        feat = (tree["feats"][i].copy() if bool(tree["hasf"][i]) else None)
        ddl = float(tree["deadline"][i])
        out.append((int(tree["rids"][i]),
                    [int(t) for t in tree["prompts"][i, : tree["plen"][i]]],
                    feat, ddl if ddl >= 0 else None))
    return out


def drain_unserved(batcher, now: Optional[float] = None) -> List[tuple]:
    """Pop every un-served queue + retry-queue entry off a batcher (or
    a ``ShardedServe`` router and its alive shards) into snapshot
    entries.  Deadlines convert to *remaining* seconds — absolute
    monotonic stamps are meaningless across a restart."""
    entries: List[tuple] = []
    clock = getattr(batcher, "_clock", None)
    if now is None:
        now = clock() if clock is not None else 0.0

    def _rem(dabs):
        return None if dabs is None else max(0.0, dabs - now)

    pending = getattr(batcher, "pending", None)
    if pending is not None:  # ShardedServe
        for rid, prompt, feat in pending:
            dabs = batcher.requests.get(rid, (None, None, None))[2]
            entries.append((rid, prompt, feat, _rem(dabs)))
        pending.clear()
        for s, b in enumerate(batcher.batchers):
            if batcher.alive[s]:
                entries.extend(drain_unserved(b, now=now))
        return entries
    while batcher.queue:
        rid, prompt, feat = batcher.queue.popleft()
        entries.append((rid, prompt, feat,
                        _rem(batcher.deadline.pop(rid, None))))
    for ent in list(getattr(batcher, "_retry_q", ())):
        _, _, rid, prompt, feat, dabs = ent
        entries.append((rid, prompt, feat, _rem(dabs)))
    if getattr(batcher, "_retry_q", None):
        batcher._retry_q.clear()
    return entries


def preempt_snapshot(batcher, manager, step: int = 0) -> int:
    """Snapshot the un-served queue via ``CheckpointManager`` (the
    SIGTERM drain path: callers stop admitting first, then drain
    in-flight work with ``run()``).  Returns the number of requests
    saved; an empty queue still writes a (empty) snapshot so
    warm-restart is unconditional."""
    entries = drain_unserved(batcher)
    manager.save(step, queue_to_tree(entries))
    manager.wait()
    return len(entries)


def warm_restart(batcher, manager) -> int:
    """Resubmit the latest queue snapshot into a fresh batcher/router.
    Returns the number of requests restored (0 when no snapshot
    exists)."""
    step = manager.latest_step()
    if step is None:
        return 0
    entries = tree_to_queue(manager.restore_flat(step))
    n = 0
    for rid, prompt, feat, ddl in entries:
        if batcher.submit(rid, prompt, features=feat, deadline_s=ddl):
            n += 1
    return n
