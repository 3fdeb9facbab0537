"""Request router over data-parallel serve shards (mirrors
``repro.serve.router``).

``ShardedServe`` puts serve shards behind one submit/run interface.  Each
shard is a ``ServeEngine`` + ``DeviceContinuousBatcher`` on the one
device, and every shard uses the same params tensors.  With a ``("data",
"model")`` mesh of logical chips (``launch.mesh.make_serve_mesh``) the
router makes one shard a data slice (``data_submeshes``), its engine and
batcher placed on that submesh, replicated or with ``tp_params=True`` by
the JAX rules; the wave's one gate call places its features on the whole
mesh (``queue_pspec``).  On one card a placement holds each tensor whole,
so a mesh of ``DATA`` slices serves bitwise what the mesh-less router
with ``n_shards=DATA`` serves, with or without ``tp_params`` (ROADMAP
C.19).  Without a mesh, ``n_shards`` shards run unplaced (the JAX
package's mesh-less mode).

Routing and drain semantics:

* requests pick their home shard by **rendezvous (HRW) hashing** over
  the *alive* shard set (stable CRC32 of ``repr(request_id)`` salted
  with the shard id, through a splitmix64 finalizer; highest weight
  wins): when a shard dies, only ITS requests remap; a shard whose queue
  depth exceeds the shallowest queue by more than ``rebalance_margin``
  spills new arrivals to the shallowest shard;
* FIFO order is preserved *within* a shard: rebalancing only picks the
  shard, never reorders a shard's queue;
* admission is ONE batched Planter-gate call over the whole pending
  wave (the ``fused_eb`` kernel for a gate-sized table on the card); the
  shards are built with ``pregate=False``, and each shard's fused step
  still runs its in-step gate over its slots;
* ``run()`` drains every shard and merges the per-shard done masks,
  timestamps and drop lists into one host-side view (``done`` /
  ``done_at`` / ``dropped`` / ``dropped_at``), mirroring the
  single-batcher API.

Fault tolerance: a shard marked dead, by an injected ``ShardCrash`` at
its drain boundary or by ``StragglerMonitor`` strikes accumulated over
``straggler_strikes`` consecutive drain rounds, has its queued AND
in-flight requests re-routed to the survivors.  In-flight requests replay
from their prompts (the router keeps a prompt/feature registry;
``done``-dedup by request id makes the replay idempotent); each hop
increments ``retries[rid]`` and a request that exhausts ``max_retries``,
or outlives every shard, drops with reason ``shard-failed``.  Deadlines
thread through: the remaining budget (not the original) rides to the new
shard.  A dead shard's batcher is told between rounds, on the host, to
stop reporting work (its queue, retry queue and carried slots); its slot
state on the device is never read again.

With one shard the schedule, and therefore every token stream, is
bitwise the lone ``DeviceContinuousBatcher``'s.  Multi-shard routers
keep that per shard: each shard's streams match a lone batcher fed the
same requests in the same order (on the paged cache a stream is a pure
function of its prompt, and on the card the products and the attention
are row- and batch-invariant).
"""
from __future__ import annotations

import time
import zlib
from typing import Any, Callable, Iterable, List, Optional, Union

import numpy as np
import torch

from ..dist import sharding as SH
from ..dist.stragglers import StragglerMonitor
from ..launch.mesh import data_submeshes
from .engine import (DeviceContinuousBatcher, ServeConfig, ServeEngine,
                     _default_seed, validate_prompt_or_drop)


def _hrw_weight(key: bytes, s: int) -> int:
    """Stable 64-bit rendezvous weight for one (request, shard) pair.

    CRC32 is the process-stable digest (``hash()`` is salted and would
    re-route requests across restarts) but it is *linear* over GF(2):
    with only the shard suffix varying, the per-shard weights form an
    XOR-coset and the argmax collapses onto two bits of the key — some
    shards become unreachable.  The splitmix64 finalizer (multiply +
    xor-shift) breaks that linearity."""
    x = zlib.crc32(key + b"|" + str(s).encode())
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & 0xFFFFFFFFFFFFFFFF


def rendezvous_shard(request_id: Any, shards: Iterable[int]) -> int:
    """Highest-random-weight (rendezvous) home shard for a request id.

    The shard with the highest :func:`_hrw_weight` wins, ties to the
    lowest shard id.  The property failover leans on: removing a shard
    from ``shards`` remaps ONLY the keys whose maximum was that shard —
    every other request keeps its home, unlike mod-N hashing where one
    death reshuffles ~all keys.
    """
    key = repr(request_id).encode()
    best_s, best_w = -1, -1
    for s in shards:
        w = _hrw_weight(key, s)
        if w > best_w:
            best_s, best_w = s, w
    if best_s < 0:
        raise ValueError("rendezvous over an empty shard set")
    return best_s


def stable_shard(request_id: Any, n_shards: int) -> int:
    """Deterministic home shard over the full shard set (rendezvous
    hash — see :func:`rendezvous_shard` for the minimal-remap
    property)."""
    return rendezvous_shard(request_id, range(n_shards))


class ShardedServe:
    """Data-parallel serve shards behind one submit/run interface.

    Engine-level knobs ride in on ``scfg``, notably
    ``ServeConfig(attn_impl=...)`` (the paged-attention backend of
    ``repro_torch.nn.attn_backend``), which every shard's engine picks up.
    ``mesh`` (its chips on ``device``) gives one shard a data slice, each
    placed on its submesh (``tp_params`` as the engine's); None serves
    ``n_shards`` unplaced shards.  ``device`` and ``graph`` (the shards'
    CUDA graphs) are the port's: the JAX package places shards by mesh
    and compiles with jit.
    """

    def __init__(self, cfg, params, scfg: ServeConfig, mesh, *,
                 gate=None, gate_backend: str = "auto", eos_token: int = 0,
                 max_tokens: int = 32, sync_every: int = 8,
                 rebalance_margin: Optional[int] = None,
                 prefill_chunk: int = 1, max_queue: Optional[int] = None,
                 tracer=None, metrics=None, n_shards: Optional[int] = None,
                 max_retries: int = 1, retry_backoff: int = 1,
                 deadline_s: Optional[float] = None,
                 fault_injector=None, straggler_threshold: float = 1.5,
                 straggler_strikes: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 spec_k: int = 0, draft=None, tp_params: bool = False,
                 device: Union[str, torch.device] = "cuda",
                 graph: bool = True):
        self.mesh = mesh
        if mesh is not None:
            self.submeshes = data_submeshes(mesh)
        else:
            # mesh-less mode: N unplaced shards on the one device
            self.submeshes = [None] * max(1, int(n_shards or 1))
        self.n_shards = len(self.submeshes)
        # depth slack before a request spills off its home shard; one
        # full slot wave by default
        self.rebalance_margin = (scfg.max_batch if rebalance_margin is None
                                 else int(rebalance_margin))
        self._clock = clock
        self.engines = [
            ServeEngine(cfg, params, scfg, gate=gate,
                        gate_backend=gate_backend, mesh=sm,
                        tp_params=tp_params, device=device)
            for sm in self.submeshes]
        # pregate=False: the router already gated the wave (one call in
        # _route), so a per-shard pre-admission call would re-derive
        # all-keep verdicts; the in-step gate is a no-op for admitted
        # requests, leaving the schedule identical to a single-host
        # batcher fed the same (kept) queue
        self.batchers = [
            DeviceContinuousBatcher(eng, eos_token=eos_token,
                                    max_tokens=max_tokens,
                                    sync_every=sync_every, pregate=False,
                                    prefill_chunk=prefill_chunk,
                                    max_queue=max_queue,
                                    max_retries=max_retries,
                                    retry_backoff=retry_backoff,
                                    fault_injector=fault_injector,
                                    clock=clock,
                                    spec_k=spec_k, draft=draft, graph=graph)
            for eng in self.engines]
        self._gate_fn = self.engines[0].gate_fn
        self._drop = scfg.gate_action_drop
        self._scfg = scfg
        self.max_tokens = int(max_tokens)
        self.pending: List[tuple] = []
        self.assigned: List[List[Any]] = [[] for _ in range(self.n_shards)]
        self.done: dict = {}
        self.done_at: dict = {}
        self._adm_dropped: List[Any] = []
        self.dropped: List[Any] = []
        self.drop_reasons: dict = {}
        self.dropped_at: dict = {}
        # ---- fault tolerance state
        self.alive: List[bool] = [True] * self.n_shards
        self.max_retries = int(max_retries)
        self.default_deadline_s = deadline_s
        self.injector = fault_injector
        # rid -> (prompt, features, absolute deadline | None): the
        # replay registry failover re-submits from
        self.requests: dict = {}
        self.retries: dict = {}  # rid -> failover hops taken
        self.failover_log: List[tuple] = []  # (shard, reason, n_moved)
        self.monitor = StragglerMonitor(self.n_shards,
                                        threshold=straggler_threshold)
        # None disables straggler eviction (timing-free determinism for
        # parity benches); N evicts after N consecutive flagged rounds
        self.straggler_strikes = straggler_strikes
        self._shard_drains = [0] * self.n_shards
        self.tracer = None
        self.metrics = None
        self.attach_obs(tracer, metrics)

    def attach_obs(self, tracer=None, metrics=None) -> None:
        """Attach ONE ``obs`` Tracer/Metrics pair fleet-wide: each
        shard batcher reports into it under its own shard id (Chrome
        trace tid = shard), and each shard's page pool gets its own
        gauge prefix so occupancy never collides across shards."""
        self.tracer = tracer
        self.metrics = metrics
        if tracer is not None and metrics is not None \
                and tracer.metrics is None:
            tracer.metrics = metrics
        for s, b in enumerate(self.batchers):
            b.attach_obs(tracer, metrics)
            b.trace_shard = s
            if metrics is not None and self._scfg.paged:
                b.pool.bind_metrics(metrics, prefix=f"pool.shard{s}")

    # ------------------------------------------------------------ admission
    def admit(self, features: np.ndarray) -> np.ndarray:
        """Batched gate call over a request wave, on the engines' device
        (keep mask, True = admit); on a mesh the feature matrix is placed
        by ``queue_pspec`` over the whole mesh (data-parallel rows)."""
        if self._gate_fn is None:
            return np.ones(len(features), bool)
        x = torch.as_tensor(np.asarray(features).astype(np.int32),
                            device=self.engines[0].device)
        if self.mesh is not None:
            x = SH.NamedSharding(self.mesh, SH.queue_pspec(
                self.mesh, len(x), x.dim())).place(x)
        return self._gate_fn(x).cpu().numpy() != self._drop

    # -------------------------------------------------------------- routing
    def submit(self, request_id, prompt_tokens,
               features: Optional[np.ndarray] = None,
               deadline_s: Optional[float] = None,
               seed: Optional[int] = None):
        """Enqueue; admission + shard placement happen batched in
        ``run()`` so routing sees whole-wave queue depths.
        ``prompt_tokens`` is a token sequence (bare int = length-1
        prompt), threaded through to the shard's chunked prefill.
        ``deadline_s`` (falls back to the router default) starts
        counting HERE — queue wait, routing, failover hops and decode
        all spend the same budget.  ``seed`` keys the request's
        sampling noise when ``temperature > 0``; it is resolved once
        here (default: hash of the request id) and rides the replay
        registry, so a failover replay re-samples the identical
        stream on the surviving shard."""
        # same validation the shard batchers apply, surfaced at submit
        # instead of mid-route (where a failed request would vanish
        # from done/dropped accounting); empty prompts record their
        # drop reason before the ValueError surfaces
        try:
            prompt = validate_prompt_or_drop(
                self._scfg, request_id, prompt_tokens, self.max_tokens,
                self._adm_dropped, self.drop_reasons,
                dropped_at=self.dropped_at)
        except ValueError:
            if (self.tracer is not None
                    and self.drop_reasons.get(request_id) == "empty-prompt"):
                self.tracer.dropped(request_id, "empty-prompt")
            raise
        if self.tracer is not None:
            # router-side stamp: queue wait measured from the moment the
            # fleet saw the request, not the shard hand-off (earliest
            # submit wins in the tracer)
            self.tracer.submitted(request_id)
        ddl = deadline_s if deadline_s is not None else self.default_deadline_s
        dabs = None
        if ddl is not None:
            if ddl <= 0:
                self._drop_admission(request_id, "deadline")
                return False
            dabs = self._clock() + float(ddl)
        feat = None if features is None else np.asarray(features)
        sd = int(seed) if seed is not None else _default_seed(request_id)
        # replay registry: failover re-submits lost requests from here
        self.requests[request_id] = (prompt, feat, dabs, sd)
        self.pending.append((request_id, prompt, feat))
        return True

    def _drop_admission(self, rid, reason: str) -> None:
        """Router-side terminal drop (never reached a shard)."""
        now = self._clock()
        self._adm_dropped.append(rid)
        self.drop_reasons[rid] = reason
        self.dropped_at[rid] = now
        if self.tracer is not None:
            if reason == "deadline":
                self.tracer.deadline_dropped(rid, t=now)
            else:
                self.tracer.dropped(rid, reason, t=now)
        elif self.metrics is not None:
            self.metrics.counter(f"serve.drop.{reason}").inc()

    def queue_depths(self) -> List[int]:
        """Un-served load per shard: device queue + in-flight slots."""
        return [b.pending_work() for b in self.batchers]

    def prefix_tokens_per_page(self) -> float:
        """Fleet-wide prefix-sharing ratio: full-page prompt tokens per
        distinct pool page, summed over every shard's page pool (1.0
        when nothing is shared; ``ServeConfig(share_prefix=True)``
        threads through ``scfg`` to each shard's pool)."""
        if not self._scfg.paged:
            return 1.0
        tokens = pages = 0
        for b in self.batchers:
            t, p = b.pool.prefix_page_counts()
            tokens += t
            pages += p
        if pages == 0:
            return 1.0
        return tokens / (self._scfg.page_size * pages)

    def _alive_shards(self) -> List[int]:
        return [s for s in range(self.n_shards) if self.alive[s]]

    def _route(self):
        pending, self.pending = self.pending, []
        keep = np.ones(len(pending), bool)
        gated = [i for i, (_, _, f) in enumerate(pending) if f is not None]
        if gated and self._gate_fn is not None:
            keep[gated] = self.admit(
                np.stack([pending[i][2] for i in gated]))
        alive = self._alive_shards()
        if not alive:
            for k, (rid, _, _) in enumerate(pending):
                self._drop_admission(
                    rid, "gate-reject" if not keep[k] else "shard-failed")
            return
        depth = self.queue_depths()
        amin = min(depth[s] for s in alive)
        for k, (rid, prompt, feat) in enumerate(pending):
            if not keep[k]:
                self._drop_admission(rid, "gate-reject")
                continue
            # rendezvous home over the ALIVE set: a dead shard's keys
            # remap, everyone else's stay put
            home = s = rendezvous_shard(rid, alive)
            if depth[s] - amin > self.rebalance_margin:
                # spill to the shallowest alive queue
                s = min(alive, key=lambda a: depth[a])
                if self.metrics is not None:
                    self.metrics.counter("router.rebalanced").inc()
                if self.tracer is not None:
                    self.tracer.instant("rebalance", tid=s,
                                        rid=repr(rid), home=home, to=s)
            _, _, dabs, sd = self.requests.get(
                rid, (None, None, None, None))
            ddl = None if dabs is None else dabs - self._clock()
            if not self.batchers[s].submit(rid, prompt, features=feat,
                                           deadline_s=ddl, seed=sd):
                continue  # shard rejected (queue-full/expired): merged
            self.assigned[s].append(rid)
            depth[s] += 1
            amin = min(depth[a] for a in alive)
        if self.metrics is not None:
            for s, d in enumerate(self.queue_depths()):
                self.metrics.gauge(f"router.queue_depth.shard{s}").set(d)

    # ------------------------------------------------------------- failover
    def _fail_shard(self, s: int, reason: str) -> None:
        """Mark shard ``s`` dead and re-route its un-served requests.

        Queued AND in-flight work moves to the survivors: everything
        ``assigned[s]`` that is neither done nor dropped replays from
        its prompt (dedup by request id — a request that already
        finished is NOT replayed, so failover can never double-serve).
        Each hop spends one of ``max_retries``; exhaustion — or an
        empty survivor set — drops the request with reason
        ``shard-failed``.  Remaining (not original) deadline budget
        rides along.
        """
        if not self.alive[s]:
            return
        self.alive[s] = False
        b = self.batchers[s]
        now = self._clock()
        # dead shard's terminal bookkeeping merges as usual (_merge
        # iterates dead batchers too); only the un-served set moves
        served = set(b.done) | set(b.dropped)
        lost = [rid for rid in self.assigned[s] if rid not in served]
        # the dead batcher must stop reporting pending work
        b.queue.clear()
        b._retry_q.clear()
        b._carry = [None] * b._B
        survivors = self._alive_shards()
        moved = 0
        for rid in lost:
            prompt, feat, dabs, sd = self.requests.get(
                rid, (None, None, None, None))
            hops = self.retries.get(rid, 0) + 1
            self.retries[rid] = hops
            if not survivors or hops > self.max_retries:
                self._drop_admission(rid, "shard-failed")
                continue
            if dabs is not None and dabs - now <= 0:
                self._drop_admission(rid, "deadline")
                continue
            to = rendezvous_shard(rid, survivors)
            ok = self.batchers[to].submit(
                rid, prompt, features=feat,
                deadline_s=None if dabs is None else dabs - now,
                seed=sd)
            if ok:
                self.assigned[to].append(rid)
                moved += 1
                if self.tracer is not None:
                    self.tracer.failed_over(rid, frm=s, to=to, t=now)
                elif self.metrics is not None:
                    self.metrics.counter(
                        "serve.requests_failed_over").inc()
        self.failover_log.append((s, reason, len(lost)))
        if self.tracer is not None:
            self.tracer.instant("shard-failed", tid=s, shard=s,
                                reason=reason, lost=len(lost), moved=moved)
        if self.metrics is not None:
            self.metrics.counter("router.shards_failed").inc()
            self.metrics.counter("router.requests_moved").inc(moved)

    # ----------------------------------------------------------------- run
    def _merge(self):
        """Fold the per-shard done masks into the single host view."""
        for b in self.batchers:
            self.done.update(b.done)
            self.done_at.update(b.done_at)
            self.drop_reasons.update(b.drop_reasons)
            self.dropped_at.update(b.dropped_at)
        self.dropped = self._adm_dropped + [
            rid for b in self.batchers for rid in b.dropped]

    def run(self, max_steps: int = 1000,
            drain_chunk: Optional[int] = None) -> dict:
        """Route the pending wave, drain every shard, merge results.

        ``max_steps`` is a per-shard decode budget (matching the
        single-batcher semantics); unfinished work carries over to the
        next ``run()`` exactly as in ``DeviceContinuousBatcher``.
        ``drain_chunk`` bounds each shard's turn so shards interleave
        (latency fairness on a single process); the default drains each
        shard fully — outputs are identical either way because bounded
        runs resume the exact schedule.

        Failure handling per drain round: an injected ``ShardCrash``
        due at a shard's drain count kills it BEFORE its turn (its work
        fails over and the survivors absorb it within the same call);
        per-turn wall times feed the ``StragglerMonitor`` (plus any
        injected ``SlowShard`` virtual delay), and a shard flagged
        ``straggler_strikes`` consecutive rounds is evicted the same
        way — unless it is the last shard standing.
        """
        self._route()
        if drain_chunk is not None:
            drain_chunk = max(1, int(drain_chunk))  # 0 would never progress
        budgets = [max_steps] * self.n_shards
        inj = self.injector
        while True:
            ran = False
            for s, b in enumerate(self.batchers):
                if not self.alive[s]:
                    continue
                if inj is not None and inj.crash_due(
                        s, self._shard_drains[s]):
                    self._fail_shard(s, "crash-injected")
                    ran = True  # survivors must absorb the moved work
                    continue
                if budgets[s] <= 0 or not b.pending_work():
                    continue
                chunk = (budgets[s] if drain_chunk is None
                         else min(drain_chunk, budgets[s]))
                t0 = self._clock()
                b.run(max_steps=chunk)
                dt = self._clock() - t0
                if inj is not None:
                    # a SlowShard fault delays *virtually*: the monitor
                    # sees the injected latency, the schedule doesn't
                    dt += inj.slow_delay(s, self._shard_drains[s])
                self.monitor.record(s, dt)
                self._shard_drains[s] += 1
                budgets[s] -= chunk
                ran = True
            if self.straggler_strikes is not None:
                self.monitor.note_round()
                for s in self.monitor.persistent(self.straggler_strikes):
                    # never evict the last shard standing: slow beats dead
                    if self.alive[s] and len(self._alive_shards()) > 1:
                        self._fail_shard(s, "straggler")
            self._merge()
            if not ran:
                return self.done
