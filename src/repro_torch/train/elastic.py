"""ElasticTrainer: the supervision loop that survives a shrinking fleet
(mirrors ``repro.train.elastic``).

Wires the four survival mechanisms of the substrate — ``StragglerMonitor``
(detection), ``replan_data_axis`` (the shrunken mesh),
``CheckpointManager`` (verified restore onto the new mesh) and
``PreemptionHandler`` (SIGTERM drain) — into one loop driven by a
deterministic :class:`repro_torch.dist.elastic.TrainFaultPlan`:

* per-step wall times (plus any injected virtual delay) feed
  ``StragglerMonitor.note_round``; a worker flagged ``min_strikes``
  rounds in a row is evicted *gracefully* — checkpoint at the current
  step, remesh, restore, zero steps lost;
* an injected host loss is *abrupt* — no checkpoint opportunity; the
  survivors restore from ``latest_valid_step()`` (falling back past a
  corrupted checkpoint, counted as ``train.ckpt_fallback``) and replay
  the lost steps;
* an injected preemption raises a real SIGTERM through the installed
  ``PreemptionHandler``: the loop drains a checkpoint at the boundary
  and warm-restarts from it on the same mesh.

Recovery invariant: the loss trajectory of every post-recovery segment is
**bitwise equal** to a fresh run restored from the same checkpoint onto
the same mesh — :meth:`ElasticTrainer.replay` is that fresh run.  Faults
are injected at step boundaries only, so a faulted run executes the same
train step over the same restored state and the same deterministic
batches as an unfaulted one.

Worker model: the process simulates an ``n_workers``-host fleet of
*logical chips* on one device (``dist.sharding.Mesh``) — worker ``w`` owns
``chips_per_host`` consecutive chip ids, and the (data, model) mesh is
rebuilt from the healthy workers' chips after every eviction via
``replan_data_axis``.  ``n_workers`` asks for ``n_workers *
chips_per_host`` chips (the port's counterpart of the JAX tests' fake
devices); without it the fleet is the physical devices //
``chips_per_host``, as in the JAX package.  The step is the port's
``make_train_step``, one a segment (the JAX loop jits one a segment);
on the one device it computes the same function on every mesh
(ROADMAP C.18).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..arch.config import ArchConfig
from ..ckpt.manager import CheckpointManager
from ..device import device_count, resolve_device
from ..dist import sharding as SH
from ..dist.elastic import TrainFaultPlan, corrupt_checkpoint
from ..dist.stragglers import (PreemptionHandler, StragglerMonitor,
                               replan_data_axis)
from ..tree import map_leaves
from . import optimizer as OPT
from .step import TrainConfig, init_train_state, make_train_step

__all__ = ["ElasticTrainer", "ElasticResult", "Segment"]


@dataclasses.dataclass
class Segment:
    """One uninterrupted stretch of training between recoveries."""
    cause: str                      # 'init' | 'straggler' | 'host-loss'
    #                                 | 'preempt'
    start: int                      # first step index executed
    ckpt_step: Optional[int]        # checkpoint restored from (None=init)
    device_ids: List[int]           # mesh chips, row-major (data, model)
    mesh_shape: List[int]           # [data, model]
    losses: List[float] = dataclasses.field(default_factory=list)
    seconds: float = 0.0            # wall time of the segment's steps

    @property
    def n_steps(self) -> int:
        return len(self.losses)


@dataclasses.dataclass
class ElasticResult:
    segments: List[Segment]
    steps_completed: int            # final step index reached
    configured_steps: int
    executed_steps: int             # includes replayed steps
    workers_start: int
    workers_final: List[int]
    losses: List[float]             # per-executed-step, all segments
    preempted_externally: bool = False

    @property
    def completed(self) -> bool:
        return self.steps_completed >= self.configured_steps


class ElasticTrainer:
    """Supervised elastic training over a simulated multi-host fleet.

    Parameters mirror ``launch/train.py``; ``plan`` is a
    :class:`~repro_torch.dist.elastic.TrainFaultPlan` (or None for a plain
    run that still survives a *real* SIGTERM by checkpoint-and-stop);
    ``device`` is where every logical chip lives (``cuda`` by default).
    """

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig, pipe,
                 manager: CheckpointManager, *, steps: int,
                 n_workers: Optional[int] = None, model_parallel: int = 1,
                 chips_per_host: Optional[int] = None,
                 plan: Optional[TrainFaultPlan] = None,
                 min_strikes: int = 3, straggler_threshold: float = 1.5,
                 ckpt_every: int = 4, seed: int = 0,
                 metrics=None, tracer=None, metrics_out: Optional[str] = None,
                 log=print, device: Union[str, torch.device] = "cuda"):
        self.cfg, self.tcfg, self.pipe = cfg, tcfg, pipe
        self.manager = manager
        self.steps = steps
        self.device = resolve_device(device)
        self.model_parallel = model_parallel
        self.chips_per_host = chips_per_host or model_parallel
        if n_workers is None:
            have = device_count(self.device)
            self.n_workers = have // self.chips_per_host
            if self.n_workers < 1:
                raise ValueError(
                    f"n_workers={self.n_workers} needs "
                    f"{self.n_workers * self.chips_per_host} devices, have "
                    f"{have} (pass n_workers: that many hosts of "
                    f"chips_per_host logical chips)")
        else:
            self.n_workers = n_workers
            if self.n_workers < 1:
                raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self._worker_devs = {
            w: list(range(w * self.chips_per_host,
                          (w + 1) * self.chips_per_host))
            for w in range(self.n_workers)}
        self.alive: List[int] = list(range(self.n_workers))
        self.min_strikes = min_strikes
        self.straggler_threshold = straggler_threshold
        self.ckpt_every = ckpt_every
        self.seed = seed
        self.plan = plan
        self._inj = plan.injector() if plan is not None else None
        self.metrics, self.tracer = metrics, tracer
        self.metrics_out = metrics_out
        self._log = log or (lambda *a, **k: None)
        self._cur: Optional[tuple] = None  # (params, state, step) for drain

    # ------------------------------------------------------------- mesh
    def _min_workers(self) -> int:
        need = -(-self.model_parallel // self.chips_per_host)  # ceil
        return max(1, need)

    def _mesh(self):
        data, model = replan_data_axis(
            len(self.alive), self.model_parallel,
            chips_per_host=self.chips_per_host)
        devs = [d for w in self.alive for d in self._worker_devs[w]]
        n = data * model
        return SH.Mesh(np.asarray(devs[:n]).reshape(data, model),
                       ("data", "model"), self.device), (data, model)

    def _mesh_from_ids(self, device_ids: List[int], shape) -> SH.Mesh:
        return SH.Mesh(np.asarray(device_ids).reshape(*shape),
                       ("data", "model"), self.device)

    # -------------------------------------------------------- shardings
    def _tree_shardings(self, params, state, mesh):
        rep = SH.NamedSharding(mesh, SH.P())
        psh = SH.param_shardings(params, mesh)
        ssh: Dict[str, Any] = {}
        for k, v in state.items():
            if k == "opt":
                ssh[k] = OPT.AdamWState(
                    m=SH.param_shardings(v.m, mesh),
                    v=SH.param_shardings(v.v, mesh), count=rep)
            elif k == "err":
                ssh[k] = SH.param_shardings(v, mesh)
            else:
                ssh[k] = map_leaves(lambda leaf: [rep] * len(leaf.parts), v)
        return {"params": psh, "state": ssh}

    def _restore(self, step: int, params, state, mesh):
        tree = {"params": params, "state": state}
        sh = self._tree_shardings(params, state, mesh)
        restored = self.manager.restore(step, tree, shardings=sh)
        return restored["params"], restored["state"]

    # ------------------------------------------------------ bookkeeping
    def _count(self, name: str, n: float = 1):
        if self.metrics is not None:
            self.metrics.counter(name).inc(n)

    def _save(self, step: int, params, state) -> None:
        self.manager.save(step, {"params": params, "state": state})
        self.manager.wait()

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipe.batch_at(step).items()}

    def _emit_step(self, step: int, loss: float, dt: float,
                   worker_times: Dict[int, float]) -> None:
        if self.tracer is not None:
            t0 = time.perf_counter() - dt
            self.tracer.span(f"step {step}", t0, t0 + dt, step=step,
                             loss=loss)
        if self.metrics is None:
            return
        m = self.metrics
        m.histogram("train.step_ms").observe(dt * 1e3)
        for w, t in worker_times.items():
            m.histogram(f"train.worker{w}.step_ms").observe(t * 1e3)
        m.gauge("train.loss").set(loss)
        m.counter("train.steps").inc()
        m.gauge("train.workers_alive").set(len(self.alive))
        if self.metrics_out:
            m.write_jsonl(self.metrics_out, kind="train-elastic", step=step)

    # ------------------------------------------------------------- run
    def run(self, params=None, state=None) -> ElasticResult:
        """Train to ``steps`` through every fault of the plan, from the
        caller's float32 masters and state or, without them,
        ``init_train_state`` from ``seed``."""
        if params is None or state is None:
            params, state = init_train_state(self.cfg, self.tcfg, self.seed,
                                             self.device)

        handler = PreemptionHandler(self._drain_cb).install()
        segments: List[Segment] = []
        losses_all: List[float] = []
        preempted_ext = False
        try:
            cause, ckpt_step, step = "init", None, 0
            while step < self.steps:
                mesh, shape = self._mesh()
                if ckpt_step is not None:
                    params, state = self._restore(ckpt_step, params, state,
                                                  mesh)
                    step = ckpt_step
                seg = Segment(cause=cause, start=step, ckpt_step=ckpt_step,
                              device_ids=mesh.device_ids(),
                              mesh_shape=list(shape))
                segments.append(seg)
                self._log(f"[elastic] segment {len(segments) - 1} "
                          f"({cause}): step {step}, mesh "
                          f"{shape[0]}x{shape[1]}, workers {self.alive}")
                t0 = time.perf_counter()
                params, state, step, verdict = self._segment(
                    mesh, params, state, step, seg, handler)
                seg.seconds = time.perf_counter() - t0
                losses_all.extend(seg.losses)
                if verdict == "done":
                    break
                if verdict == "external-preempt":
                    preempted_ext = True
                    break
                cause = verdict
                if verdict == "straggler":
                    # graceful: the eviction checkpointed at `step`
                    ckpt_step = step
                else:  # host-loss or injected preempt: last valid ckpt
                    latest = self.manager.latest_step()
                    ckpt_step = self.manager.latest_valid_step()
                    if ckpt_step is None:
                        raise RuntimeError(
                            "no valid checkpoint to recover from")
                    if latest is not None and ckpt_step != latest:
                        self._count("train.ckpt_fallback")
                        self._log(f"[elastic] latest ckpt {latest} is "
                                  f"corrupt; falling back to {ckpt_step}")
        finally:
            handler.uninstall()
            self._cur = None
        return ElasticResult(
            segments=segments, steps_completed=step,
            configured_steps=self.steps,
            executed_steps=len(losses_all),
            workers_start=self.n_workers, workers_final=list(self.alive),
            losses=losses_all, preempted_externally=preempted_ext)

    def _drain_cb(self):
        if self._cur is None:
            return
        params, state, step = self._cur
        self._save(step, params, state)

    def _segment(self, mesh, params, state, start: int, seg: Segment,
                 handler: PreemptionHandler):
        """Run steps until completion or a fault interrupts.  Returns
        ``(params, state, step, verdict)`` where verdict is ``done`` /
        ``straggler`` / ``host-loss`` / ``preempt`` /
        ``external-preempt``."""
        monitor = StragglerMonitor(
            n_workers=self.n_workers, threshold=self.straggler_threshold)
        inj = self._inj
        step = start
        with mesh:
            train_step = make_train_step(self.cfg, self.tcfg)
            while step < self.steps:
                t0 = time.perf_counter()
                batch = self._batch(step)
                params, state, loss = train_step(params, state, batch)
                loss = float(loss)
                dt = time.perf_counter() - t0
                seg.losses.append(loss)
                self._cur = (params, state, step + 1)
                done = step  # the step that just completed
                step += 1

                # --- boundary: checkpoint cadence ---------------------
                if self.manager is not None and step % self.ckpt_every == 0:
                    self._save(step, params, state)

                # --- boundary: injected checkpoint corruption ---------
                if inj is not None:
                    for ev in inj.ckpt_corruptions(done):
                        latest = self.manager.latest_step()
                        if latest is not None:
                            corrupt_checkpoint(self.manager.directory,
                                               latest, ev.what)
                            self._count("train.ckpt_corrupted")
                            self._log(f"[elastic] injected {ev.what} "
                                      f"corruption into ckpt {latest}")

                # --- boundary: preemption -----------------------------
                injected_preempt = (inj is not None
                                    and inj.preempt_due(done))
                if injected_preempt:
                    signal.raise_signal(signal.SIGTERM)
                if handler.preempted:
                    handler.drain()  # checkpoints at `step` via _cur
                    self._emit_step(done, loss, dt, {})
                    if injected_preempt:
                        # warm restart: reset the handler, recover
                        handler.preempted = False
                        handler._drained = False
                        self._count("train.preempt_restart")
                        return params, state, step, "preempt"
                    return params, state, step, "external-preempt"

                # --- boundary: worker timings + stragglers ------------
                wtimes = {}
                for w in self.alive:
                    delay = (inj.slow_delay(w, done)
                             if inj is not None else 0.0)
                    wtimes[w] = dt + delay
                    monitor.record(w, wtimes[w])
                monitor.note_round()
                self._emit_step(done, loss, dt, wtimes)
                evict = [w for w in monitor.persistent(self.min_strikes)
                         if w in self.alive]
                lost = ([w for w in inj.host_losses(done)
                         if w in self.alive] if inj is not None else [])
                gone = sorted(set(evict) | set(lost))
                if not gone:
                    continue
                if len(self.alive) - len(gone) < self._min_workers():
                    self._log(f"[elastic] refusing to evict {gone}: "
                              f"would drop below the minimum fleet")
                    continue
                if evict:
                    # graceful path: checkpoint before giving up chips
                    self._save(step, params, state)
                    self._count("train.straggler_evicted", len(evict))
                    for w in evict:
                        self._log(f"[elastic] evicting persistent "
                                  f"straggler worker {w} at step {step}")
                if lost:
                    self._count("train.host_lost", len(lost))
                    for w in lost:
                        self._log(f"[elastic] host loss: worker {w} at "
                                  f"step {step}")
                self.alive = [w for w in self.alive if w not in gone]
                self._count("train.remesh")
                if self.tracer is not None:
                    self.tracer.instant("train.remesh", args={
                        "evicted": evict, "lost": lost, "step": step})
                return (params, state, step,
                        "host-loss" if lost else "straggler")
        return params, state, step, "done"

    # ----------------------------------------------------------- replay
    def replay(self, ckpt_step: int, device_ids: List[int],
               mesh_shape, n_steps: int) -> List[float]:
        """The recovery invariant's reference run: restore ``ckpt_step``
        onto the exact mesh a recovered segment used and run ``n_steps``
        fault-free.  A segment's losses must equal this bitwise."""
        mesh = self._mesh_from_ids(device_ids, mesh_shape)
        params, state = init_train_state(self.cfg, self.tcfg, self.seed,
                                         self.device)
        params, state = self._restore(ckpt_step, params, state, mesh)
        losses = []
        with mesh:
            train_step = make_train_step(self.cfg, self.tcfg)
            for s in range(ckpt_step, ckpt_step + n_steps):
                params, state, loss = train_step(params, state,
                                                 self._batch(s))
                losses.append(float(loss))
        return losses
