"""Deterministic fault injection for elastic training (copied from
``repro.dist.elastic``, which imports no JAX; the training-side twin of
:mod:`repro_torch.serve.faults`).

The paper's deployment bar is continuity under stress: a mapped model
must keep serving while the switch keeps switching.  The serve path
has that (``serve.faults``); this module closes the training side.  A seeded,
replayable :class:`TrainFaultPlan` describes worker slowdowns (straggler
strikes), simulated host loss, SIGTERM preemption and on-disk checkpoint
corruption, and a :class:`TrainFaultInjector` surfaces them **at step
boundaries only** — the train step is never touched, so a faulted
run executes the same program as a fault-free one and post-
recovery loss trajectories stay bit-replayable.

Fault taxonomy:

* :class:`SlowWorker` — adds ``delay_s`` virtual seconds to worker
  ``worker``'s reported step time for ``n_steps`` consecutive steps
  starting at ``at_step``; fed to ``StragglerMonitor.note_round``, a
  persistent violation evicts the worker (graceful: checkpoint first,
  then remesh — no steps lost).
* :class:`HostLoss` — worker ``worker`` vanishes at the boundary after
  step ``at_step`` (abrupt: no checkpoint opportunity; the survivors
  restore from the last *valid* checkpoint and replay lost steps).
* :class:`Preempt` — SIGTERM at the boundary after step ``at_step``;
  the installed ``PreemptionHandler`` drains a checkpoint and the
  supervision loop warm-restarts from it.
* :class:`CorruptCkpt` — damages the newest on-disk checkpoint
  (truncate ``arrays.npz``, flip bytes in ``manifest.json``, or delete
  a leaf from the array archive); the next restore must detect it via
  the manifest CRCs and fall back to the previous retained step.

Step indexing: every ``at_step`` is 0-based over *completed* steps —
an event with ``at_step=k`` fires at the first boundary after step
``k`` has finished.  All queries are one-shot (windowed for
:class:`SlowWorker`): a plan applied across restarted segments injects
each failure exactly once.

This module imports neither ``jax`` nor ``torch``: fault injection is
host-side bookkeeping by design (``tests/test_torch_elastic.py`` loads
it by file path in a fresh interpreter and checks).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import zipfile
from typing import Any, Callable, List, Sequence, Tuple

__all__ = [
    "SlowWorker", "HostLoss", "Preempt", "CorruptCkpt", "TrainFaultPlan",
    "TrainFaultInjector", "corrupt_checkpoint", "CORRUPT_KINDS",
]


@dataclasses.dataclass(frozen=True)
class SlowWorker:
    """Slow worker ``worker`` by ``delay_s`` for ``n_steps`` steps."""
    worker: int
    delay_s: float
    at_step: int
    n_steps: int = 4


@dataclasses.dataclass(frozen=True)
class HostLoss:
    """Worker ``worker`` disappears after step ``at_step`` completes."""
    worker: int
    at_step: int


@dataclasses.dataclass(frozen=True)
class Preempt:
    """SIGTERM the run at the boundary after step ``at_step``."""
    at_step: int


CORRUPT_KINDS = ("arrays", "manifest", "leaf")


@dataclasses.dataclass(frozen=True)
class CorruptCkpt:
    """Damage the newest on-disk checkpoint after step ``at_step``."""
    at_step: int
    what: str = "arrays"  # 'arrays' | 'manifest' | 'leaf'

    def __post_init__(self):
        if self.what not in CORRUPT_KINDS:
            raise ValueError(
                f"CorruptCkpt.what must be one of {CORRUPT_KINDS}, "
                f"got {self.what!r}")


_KINDS = (SlowWorker, HostLoss, Preempt, CorruptCkpt)


class TrainFaultPlan:
    """An immutable, ordered set of training fault events.

    Build explicitly (``TrainFaultPlan([HostLoss(1, 10), ...])``), from
    a seed (:meth:`seeded` — parameters drawn deterministically so the
    same seed replays the same failures), or from a CLI spec string
    (:meth:`parse` — the ``--fault-plan`` flag on ``launch/train.py``).
    """

    def __init__(self, faults: Sequence[Any] = ()):
        for f in faults:
            if not isinstance(f, _KINDS):
                raise TypeError(f"not a training fault event: {f!r}")
        self.faults: Tuple[Any, ...] = tuple(faults)

    def __repr__(self):
        return f"TrainFaultPlan({list(self.faults)!r})"

    def __iter__(self):
        return iter(self.faults)

    def __len__(self):
        return len(self.faults)

    def injector(self) -> "TrainFaultInjector":
        return TrainFaultInjector(self)

    @classmethod
    def seeded(cls, seed: int, *, n_workers: int, ckpt_every: int = 4,
               min_strikes: int = 3, slow: bool = True,
               host_loss: bool = True, corrupt: bool = True,
               preempt: bool = True) -> "TrainFaultPlan":
        """Draw one event per requested kind from ``seed``.

        Events are staged in non-overlapping windows keyed to the
        checkpoint cadence so a seeded plan always *fires* and always
        *recovers*:

        * the slowdown starts at step 1 and lasts ``min_strikes + 2``
          steps, so the straggler is evicted mid-window (graceful
          checkpoint + remesh);
        * the corruption lands right after the second retained
          checkpoint exists, damaging the then-latest one;
        * the host loss follows the corruption, forcing a restore that
          must fall back past the damaged step;
        * the preemption fires in the final stretch, past the third
          checkpoint.

        The slowdown and the host loss always target *different*
        workers (evicting the same worker twice would be a no-op and
        the host-loss event would never observably fire), and neither
        targets worker 0 so at least one original worker survives to
        the end.
        """
        if n_workers < 3:
            raise ValueError(
                f"a seeded plan needs >= 3 workers to stage both a "
                f"straggler eviction and a host loss, got {n_workers}")
        rng = random.Random(seed)
        faults: List[Any] = []
        slow_w = rng.randrange(1, n_workers)
        if slow:
            # virtual seconds are free — draw them large enough to
            # dominate even a segment-first-step compile outlier in the
            # fleet median, so the strike count is schedule-exact
            faults.append(SlowWorker(
                worker=slow_w, delay_s=rng.uniform(8.0, 16.0), at_step=1,
                n_steps=min_strikes + 2))
        if corrupt:
            faults.append(CorruptCkpt(
                at_step=2 * ckpt_every, what=rng.choice(CORRUPT_KINDS)))
        if host_loss:
            others = [w for w in range(1, n_workers) if w != slow_w]
            faults.append(HostLoss(
                worker=rng.choice(others), at_step=2 * ckpt_every + 2))
        if preempt:
            faults.append(Preempt(at_step=3 * ckpt_every + 1))
        return cls(faults)

    @classmethod
    def parse(cls, spec: str) -> "TrainFaultPlan":
        """Parse a CLI plan: comma-separated ``kind:args@step`` events.

        * ``slow:<worker>:<delay_s>@<step>`` /
          ``slow:<worker>:<delay_s>:<n_steps>@<step>``
        * ``lost:<worker>@<step>``
        * ``preempt@<step>``
        * ``corrupt@<step>`` / ``corrupt:<what>@<step>``
          (``what`` in ``arrays|manifest|leaf``)
        * ``seed:<n>:<n_workers>`` — shorthand for
          :meth:`seeded`; ``seed:<n>:<n_workers>:<ckpt_every>`` to
          match a non-default checkpoint cadence.
        """
        faults: List[Any] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            head, _, step_s = part.partition("@")
            bits = head.split(":")
            kind, args = bits[0], bits[1:]
            if kind == "seed":
                ckpt_every = int(args[2]) if len(args) > 2 else 4
                faults.extend(cls.seeded(
                    int(args[0]), n_workers=int(args[1]),
                    ckpt_every=ckpt_every).faults)
                continue
            if not step_s:
                raise ValueError(f"fault event needs @<step>: {part!r}")
            step = int(step_s)
            if kind == "slow":
                faults.append(SlowWorker(
                    worker=int(args[0]), delay_s=float(args[1]),
                    at_step=step,
                    n_steps=int(args[2]) if len(args) > 2 else 4))
            elif kind == "lost":
                faults.append(HostLoss(worker=int(args[0]), at_step=step))
            elif kind == "preempt":
                faults.append(Preempt(at_step=step))
            elif kind == "corrupt":
                faults.append(CorruptCkpt(
                    at_step=step, what=args[0] if args else "arrays"))
            else:
                raise ValueError(f"unknown fault kind {kind!r} in {part!r}")
        return cls(faults)


class TrainFaultInjector:
    """Per-run consumption state over a :class:`TrainFaultPlan`.

    One-shot queries (windowed for :class:`SlowWorker`): an event that
    fires moves to :attr:`fired` and never fires again, so a plan
    applied across remesh/restart segments injects each failure exactly
    once.  The injector is passive — the supervision loop polls it at
    its own step boundaries; it never touches device state itself.
    """

    def __init__(self, plan: TrainFaultPlan):
        self._pending: List[Any] = list(plan.faults)
        self.fired: List[Any] = []

    def _take(self, match: Callable[[Any], bool]) -> List[Any]:
        due = [f for f in self._pending if match(f)]
        for f in due:
            self._pending.remove(f)
            self.fired.append(f)
        return due

    # ------------------------------------------------------------ queries
    def slow_delay(self, worker: int, step: int) -> float:
        """Virtual seconds to add to ``worker``'s reported time for
        ``step``.  A slowdown whose window has passed is retired; one
        inside its window keeps contributing until it expires (the
        ``fired`` record is written on first contribution)."""
        total = 0.0
        for f in list(self._pending):
            if not isinstance(f, SlowWorker):
                continue
            if step >= f.at_step + f.n_steps:
                self._pending.remove(f)
                if f not in self.fired:
                    self.fired.append(f)
                continue
            if f.worker == worker and f.at_step <= step:
                total += f.delay_s
                if f not in self.fired:
                    self.fired.append(f)
        return total

    def host_losses(self, step: int) -> List[int]:
        """Workers lost at this boundary (one-shot, sorted)."""
        return sorted(f.worker for f in self._take(
            lambda f: isinstance(f, HostLoss) and f.at_step <= step))

    def preempt_due(self, step: int) -> bool:
        """True once, at the boundary where a preemption is due."""
        return bool(self._take(
            lambda f: isinstance(f, Preempt) and f.at_step <= step))

    def ckpt_corruptions(self, step: int) -> List[CorruptCkpt]:
        return self._take(
            lambda f: isinstance(f, CorruptCkpt) and f.at_step <= step)

    # ---------------------------------------------------------- inspection
    def pending(self) -> List[Any]:
        return list(self._pending)

    def pending_kinds(self, kind: type) -> List[Any]:
        return [f for f in self._pending if isinstance(f, kind)]


# --------------------------------------------------------------------------
# On-disk checkpoint corruption: the host-side damage model CorruptCkpt
# events apply.  Pure file surgery — CheckpointManager.verify() must
# catch every one of these via the manifest CRCs (tests/test_ckpt.py).
# --------------------------------------------------------------------------

def _step_dir(directory: str, step: int) -> str:
    d = os.path.join(directory, f"step_{step:09d}")
    if not os.path.isdir(d):
        raise FileNotFoundError(f"no checkpoint dir for step {step}: {d}")
    return d


def corrupt_checkpoint(directory: str, step: int,
                       what: str = "arrays") -> str:
    """Damage checkpoint ``step`` under ``directory`` in place.

    * ``arrays`` — truncate ``arrays.npz`` to half its size (torn
      write / partial disk);
    * ``manifest`` — flip one byte in the middle of ``manifest.json``
      (bit rot);
    * ``leaf`` — rewrite ``arrays.npz`` without its first member
      (silently dropped shard file).

    Returns the path that was damaged.
    """
    d = _step_dir(directory, step)
    if what == "arrays":
        path = os.path.join(d, "arrays.npz")
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
        return path
    if what == "manifest":
        path = os.path.join(d, "manifest.json")
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
        return path
    if what == "leaf":
        path = os.path.join(d, "arrays.npz")
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
            keep = {n: zf.read(n) for n in names[1:]}
        if not keep:
            raise ValueError("cannot drop the only leaf in arrays.npz")
        tmp = path + ".corrupt"
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
            for n, blob in keep.items():
                zf.writestr(n, blob)
        os.replace(tmp, path)
        return path
    raise ValueError(f"unknown corruption kind {what!r}")


def describe(plan: TrainFaultPlan) -> List[str]:
    """Human/JSON-friendly one-liners for a plan (bench provenance)."""
    out = []
    for f in plan:
        if isinstance(f, SlowWorker):
            out.append(f"slow worker {f.worker} +{f.delay_s:.2f}s "
                       f"steps [{f.at_step}, {f.at_step + f.n_steps})")
        elif isinstance(f, HostLoss):
            out.append(f"host loss worker {f.worker} @ step {f.at_step}")
        elif isinstance(f, Preempt):
            out.append(f"SIGTERM @ step {f.at_step}")
        elif isinstance(f, CorruptCkpt):
            out.append(f"corrupt latest ckpt ({f.what}) @ step {f.at_step}")
    return out


def plan_to_json(plan: TrainFaultPlan) -> str:
    """Stable JSON encoding (bench artifacts record the exact plan)."""
    return json.dumps([
        {"kind": type(f).__name__, **dataclasses.asdict(f)} for f in plan])
