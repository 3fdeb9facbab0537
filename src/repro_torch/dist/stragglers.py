"""Elasticity: straggler detection, mesh replanning, preemption handling.

Three independent mechanisms a long-running pod job needs:

* :class:`StragglerMonitor` — per-worker step-time medians over a sliding
  window; a worker whose median exceeds ``threshold`` × the fleet median
  is flagged (median-of-medians is robust to the stragglers themselves
  polluting the baseline);
* :func:`replan_data_axis` — after host loss/gain, re-derive the largest
  power-of-two data-parallel degree the surviving chips support at a
  fixed model-parallel degree (the elastic shrink/grow plan; restore onto
  the new mesh via ``CheckpointManager.restore(..., shardings=...)``);
* :class:`PreemptionHandler` — SIGTERM-driven checkpoint-then-stop: the
  handler sets ``preempted``; the training loop calls :meth:`drain` at
  the next step boundary to run the checkpoint callback and exit
  cleanly.  (Checkpointing *inside* the signal handler is unsafe here:
  the step is jitted with donated arguments, and a signal landing
  mid-statement can observe params whose buffers were already donated.)
"""
from __future__ import annotations

import signal
import statistics
from collections import deque
from typing import Callable, Dict, List, Optional

CHIPS_PER_HOST = 4  # accelerators per host on the reference fleet


class StragglerMonitor:
    """Detect slow workers from reported per-step wall times."""

    def __init__(self, n_workers: int, threshold: float = 1.5,
                 window: int = 64):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_workers = n_workers
        self.threshold = threshold
        self._times: List[deque] = [deque(maxlen=window)
                                    for _ in range(n_workers)]
        # consecutive rounds each worker has been flagged (note_round):
        # eviction decisions key off *persistent* violation, so one noisy
        # step never costs a worker its shard
        self._strikes: List[int] = [0] * n_workers

    def record(self, worker: int, seconds: float) -> None:
        self._times[worker].append(float(seconds))

    def medians(self) -> Dict[int, float]:
        """Per-worker median step time (workers with no reports omitted)."""
        return {w: statistics.median(t)
                for w, t in enumerate(self._times) if t}

    def stragglers(self) -> List[int]:
        """Workers whose median step time exceeds threshold × fleet median."""
        meds = self.medians()
        if len(meds) < 2:
            return []
        fleet = statistics.median(meds.values())
        return [w for w, m in sorted(meds.items())
                if m > self.threshold * fleet]

    def note_round(self) -> List[int]:
        """Close one observation round: flagged workers gain a strike,
        clean workers reset to zero.  Returns this round's stragglers."""
        flagged = set(self.stragglers())
        for w in range(self.n_workers):
            self._strikes[w] = self._strikes[w] + 1 if w in flagged else 0
        return sorted(flagged)

    def strikes(self, worker: int) -> int:
        return self._strikes[worker]

    def persistent(self, min_strikes: int) -> List[int]:
        """Workers flagged in >= ``min_strikes`` *consecutive* rounds —
        the router's evict-this-shard signal."""
        return [w for w in range(self.n_workers)
                if self._strikes[w] >= min_strikes]


def replan_data_axis(n_healthy_hosts: int, model_parallel: int,
                     chips_per_host: int = CHIPS_PER_HOST):
    """(data, model) mesh axes after an elastic shrink/grow.

    Model parallelism is pinned (params are laid out for it); the data
    axis becomes the largest power of two that fits on the healthy chips,
    so the global batch keeps dividing evenly and collectives stay
    power-of-two shaped.
    """
    chips = n_healthy_hosts * chips_per_host
    avail = chips // model_parallel
    if avail < 1:
        raise ValueError(
            f"{chips} chips cannot host model_parallel={model_parallel}")
    data = 1
    while data * 2 <= avail:
        data *= 2
    return data, model_parallel


class PreemptionHandler:
    """Checkpoint-and-stop on SIGTERM (cluster preemption notice).

    ``install()`` registers the handler and returns ``self``.  On signal
    only ``preempted`` flips — the handler does *not* checkpoint, because
    the signal can land mid-train-step while donated input buffers are
    already invalid.  The step loop checks ``preempted`` at its next
    boundary (params/state rebound, safe) and calls :meth:`drain`, which
    runs the checkpoint callback exactly once.  ``uninstall()`` restores
    the previous handlers.
    """

    def __init__(self, checkpoint_cb: Callable[[], None],
                 signals=(signal.SIGTERM,)):
        self._cb = checkpoint_cb
        self._signals = tuple(signals)
        self._prev: Dict[int, object] = {}
        self._drained = False
        self.preempted = False

    def _handle(self, signum, frame) -> None:
        self.preempted = True

    def drain(self) -> bool:
        """Run the checkpoint callback (once) if a preemption is pending."""
        if self.preempted and not self._drained:
            self._drained = True
            self._cb()
            return True
        return False

    def install(self) -> "PreemptionHandler":
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
