"""Serving engine over the dense ring cache or the paged KV cache, with a
Planter admission gate.

Mirrors ``repro.serve.engine``.  Both batchers run either decode-cache
layout, as the JAX package's do:

* **dense** (the default, no ``page_size``): one global position and the
  ``[B, cache_len]`` ring cache (``arch.model.decode_step``), one token a
  slot a step; a slot filled mid-run starts at the global position and
  sees the cells its slot held before (the JAX package's semantics, kept
  as they are).  The device batcher takes single-token prompts only; the
  host batcher loops a longer prompt through the cache a token a step.
* **paged** (``ServeConfig(page_size=...)``): the block-table page pool
  with per-slot positions and chunked prefill.

* ``ServeEngine`` holds the model parameters on the device, the lazy dense
  decode state (``state``) with its step (``step``: logits, the gate fused
  when features are given) and greedy ``generate`` (the argmax stays on
  the device; one sync at the end), the lazy physical page pool
  (``paged_kv``), the chunked paged step (``step_paged`` greedy,
  ``step_paged_logits`` for sampling), the copy-on-write page copy of
  prefix sharing (``copy_page``) and the admission gate (``admit``: the
  Planter-mapped classifier through ``MappedModel.torch_predict("auto",
  device)``, the ``fused_eb`` kernel for a gate-sized table on the card).
* ``ContinuousBatcher`` is the host-driven slot scheduler: ascending-slot
  fill from a FIFO queue, one token per slot per step (prompt tokens
  first, then the last generated token), EOS / max-token eviction, greedy
  or sampled decoding, deadlines and queue-full retries; in paged mode the
  refcounted ``PagePool`` with reservation-based admission, prefix sharing
  (``share_prefix``) and the int8 page pool (``kv_int8``).  Dropped requests record a
  reason: ``gate-reject``, ``queue-full``, ``empty-prompt``, ``deadline``,
  ``quarantined``.
* ``DeviceContinuousBatcher`` is the serve hot path: the same schedule
  with the slot state on the device and fill -> gate -> decode -> sample
  -> evict as one fused step (``_FusedStep``, or ``_DenseStep`` over the
  ring cache), ``prefill_chunk`` prompt tokens a slot a step (paged),
  ``sync_every`` steps a host round trip; on the card each step shape is
  a CUDA graph.  With ``spec_k`` and a table-
  mapped ``draft`` (``serve.spec``) a decoding slot drafts ``spec_k``
  tokens in the step and the LM verifies the chain in the same launch.

Both batchers take an ``obs`` ``Tracer`` / ``Metrics`` pair
(``attach_obs``) and a ``serve.faults`` injector, applied at host drain
boundaries only: the device batcher's traced run replays the fill
schedule on the host from the drained state, so its captured step is the
untraced one.

The request router over several such batchers is
``serve.router.ShardedServe``.  An engine and a device batcher take a
``dist.sharding.Mesh`` of logical chips on their device (``mesh``, and
``tp_params`` for the engine): the params are placed replicated, or with
``tp_params`` by ``param_shardings``; the caches, the page pools, the
device batcher's slot state and queue by the JAX package's serve rules.
On one card a placement validates each tensor's spec and holds it whole
there, so a mesh moves no tensor, adds no capture and no sync, and a
tensor-parallel engine serves bitwise what a replicated one does (ROADMAP
C.19).

Over a mesh of ranks of one data slice (``dist.sharding.RankMesh``, one
rank a card, or ranks on the CPU or sharing a card) every rank of the
slice runs the engine and its batcher on the same requests: the params
replicated, the page pool and the ring split over ``model`` by the JAX
rules (each rank writes its rows and gathers each layer's cache from its
``model`` row before the attention, ``nn.attention``), the slot state and
the queue replicated.  Every host decision (admission, drain, eviction,
the fault injector's plan, the gate's verdict) comes from state that
every rank holds bitwise, and a decision that reads the time reads the
slice's one clock (``_decision_clock``: its lead rank's, broadcast), so
the ranks stay in lockstep and serve the mesh-less engine's streams
bitwise.  Over NCCL the device batcher captures each step with its
gathers in the CUDA graph; over gloo it runs the step eagerly.  Several
data slices over ranks serve through the router (``serve.router``).

With ``tp_params`` over a mesh of ranks the params split over the
slice's ``model`` group by whole heads, columns and experts
(``dist.sharding.tp_layout`` / ``tp_place``; ``self.tp`` is this rank's
``TensorParallel``; None over a ``model`` group of one rank, which
serves replicated), and the pools and rings hold the rank's KV heads:
each rank computes its own part of every split block, a rank-ordered
sum (``dist.comm.reduce_sum``) joins the row-parallel partials and the
head's logits are gathered, so every rank ends each layer with the same
bits and samples the same logits; over NCCL the device batcher's graph
captures the sums and gathers.  Its streams are the replicated engine's
up to the row-parallel sums' other association (ROADMAP C.19, C.21).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import heapq
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..arch import model as M
from ..arch import sampling as S
from ..arch.config import ArchConfig
from ..core.pipeline import MappedModel
from ..device import resolve_device
from ..dist import comm
from ..dist import sharding as SH
from ..nn import attention as A
from ..nn import attn_backend as AB
from .faults import PoolExhaust
from .pages import PagePool
from .pages import page_demand as _page_demand

def _check_mesh(mesh, device: torch.device) -> None:
    """A mesh's chips must live on the device that serves: a placement
    moves no tensor to another device.  An engine or a batcher on a mesh
    of ranks serves one data slice; several slices serve through the
    router."""
    md = torch.device(mesh.device)
    if md.type == "cuda" and md.index is None:
        md = torch.device("cuda", torch.cuda.current_device())
    if md != device:
        raise ValueError(f"the mesh's chips live on {mesh.device}, the "
                         f"engine serves on {device}: build the mesh on "
                         f"the engine's device")
    if isinstance(mesh, SH.RankMesh):
        if int(np.prod([n for a, n in mesh.shape.items()
                        if a != SH.MODEL_AXIS])) != 1:
            raise ValueError(
                f"a lone engine or batcher serves one data slice, not the "
                f"rank mesh {dict(mesh.shape)}: serve its slices through "
                f"the router (serve.router.ShardedServe)")


def _decision_clock(mesh, clock: Callable[[], float]) -> Callable[[], float]:
    """The clock a batcher on ``mesh`` takes its decisions by (deadline
    stamps, expiry, evictions, retries): over a mesh of several ranks, the
    lead rank's ``clock`` broadcast over the mesh's group
    (``dist.comm.SharedClock``), so that every rank of the slice evicts
    alike; else ``clock``.  A stamp only this rank reads (``done_at``,
    ``dropped_at``, a tracer's times) stays on ``clock``."""
    if isinstance(mesh, SH.RankMesh) and mesh.size > 1:
        return comm.SharedClock(clock, mesh.group, mesh.lead)
    return clock


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    cache_len: int = 256
    gate_action_drop: int = 1  # gate label that means "drop request"
    # paged KV cache geometry: page_size > 0 is the block-table cache;
    # ``pages`` sizes the physical pool (0 = cache_len worth of pages per
    # slot, the dense-equivalent footprint; smaller pools oversubscribe)
    page_size: int = 0
    pages: int = 0
    # prefix sharing: requests with a common token prefix map their full
    # prefix pages to shared read-only pool entries (refcounted,
    # copy-on-write on the partial tail page)
    share_prefix: bool = False
    # int8 page pool: quantize_kv_int8 on write, dequantize in attention
    kv_int8: bool = False
    # cap on pages the prefix cache may hold (None = pool minus one slot)
    prefix_hold_budget: Optional[int] = None
    # paged-attention backend of this package's registry: 'auto' = the
    # CUDA kernel on the card, the plain version on the CPU; 'cuda' and
    # 'torch' force one
    attn_impl: str = "auto"
    # sampling: temperature 0 is exact greedy argmax; > 0 draws
    # counter-based noise keyed by (request seed, generated-token index)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got "
                f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}")
        if self.temperature == 0.0 and (self.top_k or self.top_p < 1.0):
            raise ValueError(
                "top_k/top_p filter a sampling distribution; with "
                "temperature=0 decoding is exact greedy argmax — set "
                "temperature > 0 to enable the filters")
        if self.page_size:
            if self.cache_len % self.page_size:
                raise ValueError(
                    f"cache_len {self.cache_len} must be a multiple of "
                    f"page_size {self.page_size}")
        elif self.share_prefix or self.kv_int8:
            raise ValueError(
                "share_prefix/kv_int8 are page-pool features: set "
                "ServeConfig(page_size=...) to enable the paged cache")
        if self.attn_impl not in AB.valid_impls():
            raise ValueError(
                f"attn_impl must be one of {AB.valid_impls()}; "
                f"got {self.attn_impl!r}")

    @property
    def paged(self) -> bool:
        return self.page_size > 0

    @property
    def pages_per_slot(self) -> int:
        return self.cache_len // self.page_size

    @property
    def n_pages(self) -> int:
        return self.pages or self.max_batch * self.pages_per_slot

    @property
    def kv_dtype(self) -> str:
        return "int8" if self.kv_int8 else "bf16"

    @property
    def hold_budget(self) -> int:
        if self.prefix_hold_budget is not None:
            return self.prefix_hold_budget
        return max(0, self.n_pages - min(self.n_pages, self.pages_per_slot))

    def make_pool(self) -> PagePool:
        """The host-side page allocator."""
        return PagePool(self.n_pages, self.page_size,
                        share_prefix=self.share_prefix,
                        hold_budget=self.hold_budget)


def page_demand(scfg: ServeConfig, prompt_len: int, max_tokens: int) -> int:
    """Pages a request pins while live (prompt + worst-case decode)."""
    return _page_demand(scfg.page_size, prompt_len, max_tokens)


def validate_prompt(scfg: ServeConfig, prompt_tokens, max_tokens: int,
                    dense_ok: bool = False) -> list:
    """Normalize a submitted prompt (bare int = length 1) and check that it
    can ever be served."""
    prompt = ([int(prompt_tokens)] if np.isscalar(prompt_tokens)
              else [int(t) for t in prompt_tokens])
    if not prompt:
        raise ValueError(
            "empty prompt: a request must carry at least one token — it "
            "can never produce output and would reserve zero-demand pages")
    if scfg.paged:
        demand = page_demand(scfg, len(prompt), max_tokens)
        if demand > min(scfg.n_pages, scfg.pages_per_slot):
            raise ValueError(
                f"prompt of {len(prompt)} tokens + {max_tokens} decode "
                f"tokens needs {demand} pages, but only "
                f"{min(scfg.n_pages, scfg.pages_per_slot)} fit")
    elif len(prompt) > 1 and not dense_ok:
        raise ValueError(
            "multi-token prompts need the paged cache "
            "(ServeConfig(page_size=...)); the dense cache has one "
            "global position per step")
    return prompt


def validate_prompt_or_drop(scfg: ServeConfig, request_id, prompt_tokens,
                            max_tokens: int, dropped: list,
                            drop_reasons: dict,
                            dense_ok: bool = False,
                            dropped_at: Optional[dict] = None) -> list:
    """``validate_prompt`` that records an empty prompt as dropped
    (reason ``empty-prompt``) before the ValueError surfaces."""
    try:
        return validate_prompt(scfg, prompt_tokens, max_tokens, dense_ok)
    except ValueError as e:
        if "empty prompt" in str(e):
            dropped.append(request_id)
            drop_reasons[request_id] = "empty-prompt"
            if dropped_at is not None:
                dropped_at[request_id] = time.perf_counter()
        raise


def _default_seed(request_id) -> int:
    """Sampling seed of a request submitted without one: a CRC32 of the
    request id's repr, the JAX package's rule, so both give a request the
    same stream."""
    return zlib.crc32(repr(request_id).encode()) & 0x7FFFFFFF


def _drop_request(b, rid, reason: str, now: Optional[float] = None,
                  trace: bool = True) -> None:
    """Terminal-drop bookkeeping: reason, wall-clock stamp, deadline
    cleanup, tracer emission (``trace=False``: the traced device run emits
    from its schedule replay instead)."""
    now = b._clock() if now is None else now
    b.dropped.append(rid)
    b.drop_reasons[rid] = reason
    b.dropped_at[rid] = now
    b.deadline.pop(rid, None)
    if trace and b.tracer is not None:
        if reason == "deadline":
            b.tracer.deadline_dropped(rid, t=now, shard=b.trace_shard)
        elif reason == "quarantined":
            b.tracer.quarantined(rid, t=now, shard=b.trace_shard)
        else:
            b.tracer.dropped(rid, reason, t=now)


def _defer_full(b, rid, prompt, feat, dabs) -> None:
    """Queue-full with retries enabled: park the request in the backoff
    queue, due ``retry_backoff`` drain boundaries from now."""
    b._retry_q.append([b._drains + b.retry_backoff, 1, rid, prompt,
                       feat, dabs])
    if b.metrics is not None:
        b.metrics.counter("serve.queue_full_deferred").inc()


def _service_retries(b) -> None:
    """Re-attempt deferred submissions whose backoff expired.  Entry:
    ``[due_drain, attempt, rid, prompt, feat, deadline_abs]``; a still-full
    queue reschedules with exponential backoff until ``max_retries``, then
    drops ``queue-full``; an expired deadline drops ``deadline``."""
    if not b._retry_q:
        return
    now = b._now()
    rest: collections.deque = collections.deque()
    while b._retry_q:
        ent = b._retry_q.popleft()
        due, attempt, rid, prompt, feat, dabs = ent
        if dabs is not None and now > dabs:
            _drop_request(b, rid, "deadline", now)
            continue
        if due > b._drains:
            rest.append(ent)
            continue
        if b.max_queue is None or len(b.queue) < b.max_queue:
            if dabs is not None:
                b.deadline[rid] = dabs
            b.queue.append((rid, prompt, feat))
            if b.tracer is not None:
                b.tracer.retried(rid, attempt=attempt, t=now,
                                 shard=b.trace_shard)
            elif b.metrics is not None:
                b.metrics.counter("serve.requests_retried").inc()
            continue
        if attempt >= b.max_retries:
            _drop_request(b, rid, "queue-full", now)
            continue
        ent[0] = b._drains + b.retry_backoff * (1 << attempt)
        ent[1] = attempt + 1
        rest.append(ent)
    b._retry_q = rest


def _attach_obs(b, tracer, metrics) -> None:
    """Attach an ``obs`` Tracer/Metrics pair to a batcher (None detaches);
    the metrics also mirror the page pool's allocator activity (paged)."""
    b.tracer = tracer
    b.metrics = metrics
    if tracer is not None and metrics is not None and tracer.metrics is None:
        tracer.metrics = metrics
    if metrics is not None and b.pool is not None:
        b.pool.bind_metrics(metrics)


def _submit_traced(b, request_id, prompt_tokens, dense_ok: bool) -> list:
    """``validate_prompt_or_drop`` plus the tracer's submit (or empty-prompt
    drop) event."""
    try:
        prompt = validate_prompt_or_drop(
            b.engine.scfg, request_id, prompt_tokens, b.max_tokens,
            b.dropped, b.drop_reasons, dense_ok=dense_ok,
            dropped_at=b.dropped_at)
    except ValueError:
        if (b.tracer is not None
                and b.drop_reasons.get(request_id) == "empty-prompt"):
            b.tracer.dropped(request_id, "empty-prompt")
        raise
    if b.tracer is not None:
        b.tracer.submitted(request_id)
    return prompt


class ServeEngine:
    """The model, its decode cache (the dense ring or the page pool) and the
    admission gate on one device, optionally placed on a mesh of logical
    chips there (``mesh``, ``tp_params``; the module docstring)."""

    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig,
                 gate: Optional[MappedModel] = None,
                 gate_backend: str = "auto", mesh=None,
                 tp_params: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.tp_params = bool(tp_params)
        self.tp = None  # this rank's TensorParallel over ranks
        if mesh is not None:
            # placed once: replicated over the shard's chips, or with
            # tp_params each leaf by the JAX rules; on logical chips a leaf
            # is validated and held whole either way, so the TP streams are
            # the replicated streams bitwise (ROADMAP C.19); over ranks a
            # leaf is this rank's slice by the head-aligned layout, or whole
            # where the model group is one rank
            _check_mesh(mesh, self.device)
            ranks = M.check_ranks(cfg, mesh)
            if ranks and self.tp_params:
                self.tp = SH.tensor_parallel(cfg, mesh)
            if self.tp is not None:
                params = SH.tp_place(params, self.tp, self.device)
            else:
                params = SH.place(params, SH.param_shardings(params, mesh)
                                  if tp_params and not ranks
                                  else SH.NamedSharding(mesh, SH.P()))
        self.params = params
        self.scfg = scfg
        self.gate = gate
        self.gate_fn = (gate.torch_predict(gate_backend, device=self.device)
                        if gate is not None else None)
        # the caches are lazy: the host-driven paths touch them, and the
        # device batcher keeps its own
        self._state = None
        self._paged_kv = None

    # ------------------------------------------------------------ dense
    @property
    def state(self):
        """The dense decode state (``arch.model.init_decode_state``),
        allocated on first use."""
        if self._state is None:
            self._state = M.init_decode_state(
                self.cfg, self.scfg.max_batch, self.scfg.cache_len,
                device=self.device, mesh=self.mesh, tp=self.tp)
        return self._state

    @state.setter
    def state(self, value) -> None:
        self._state = value

    def _gate(self, features) -> Optional[torch.Tensor]:
        """The gate's labels on the device, or None without a gate or
        features."""
        if self.gate_fn is None or features is None:
            return None
        return self.gate_fn(self._ints(features))

    def step(self, tokens, features=None, block: bool = True):
        """One dense decode step for the whole batch, ``tokens [B, 1]``;
        the gate runs in the same step when ``features`` are given.
        Returns ``(logits [B, Vp] float32, labels or None)``, as numpy, or
        with ``block=False`` as tensors on the device (no host sync)."""
        labels = self._gate(features)
        logits, self._state = M.decode_step(
            self.params, self.state, self._ints(tokens), self.cfg,
            attn_impl=self.scfg.attn_impl, tp=self.tp)
        if not block:
            return logits, labels
        return (logits.cpu().numpy(),
                None if labels is None else labels.cpu().numpy())

    def generate(self, prompts, n_tokens: int, features=None,
                 block: bool = True):
        """Greedy generation; ``prompts [B, P]`` seed the cache token by
        token, then ``n_tokens`` are generated.  The argmax stays on the
        device and the gate (with ``features``) runs in every step, as in
        the JAX package's fused step; the one sync is the result (none
        with ``block=False``, which returns the ``[B, n_tokens]`` int32
        tensor)."""
        prompts = np.asarray(prompts)
        B, P = prompts.shape
        if B != self.scfg.max_batch:
            raise ValueError(f"generate takes max_batch = "
                             f"{self.scfg.max_batch} prompts, got {B}")
        dprompts = self._ints(prompts)
        feats = None if features is None else self._ints(features)
        out = []
        tok = dprompts[:, :1]
        for i in range(P + n_tokens - 1):
            self._gate(feats)
            nxt, self._state = M.decode_step(
                self.params, self.state, tok, self.cfg, sample_greedy=True,
                attn_impl=self.scfg.attn_impl, tp=self.tp)
            nxt = nxt[:, None]
            tok = dprompts[:, i + 1: i + 2] if i + 1 < P else nxt
            if i + 1 >= P:
                out.append(nxt)
        res = (torch.cat(out, 1) if out else
               torch.zeros((B, 0), dtype=torch.int32, device=self.device))
        return res.cpu().numpy() if block else res

    # ------------------------------------------------------------ paged
    def _require_paged(self) -> None:
        if not self.scfg.paged:
            raise ValueError("the page pool and the paged step need "
                             "ServeConfig(page_size=...); this engine "
                             "serves the dense ring cache")

    @property
    def paged_kv(self) -> AB.PagedKV:
        """The physical page pool, allocated on first use."""
        self._require_paged()
        if self._paged_kv is None:
            self._paged_kv = M.init_paged_kv(
                self.cfg, self.scfg.n_pages, self.scfg.page_size,
                kv_dtype=self.scfg.kv_dtype, device=self.device,
                mesh=self.mesh, tp=self.tp)
        return self._paged_kv

    def copy_page(self, src: int, dst: int) -> None:
        """Copy physical page ``src`` over ``dst`` in every layer and pool
        tensor, scales included (the copy-on-write of prefix sharing:
        ``dst`` is a fresh page no other request can see)."""
        for pool in self.paged_kv.pools():
            pool[:, dst] = pool[:, src]

    def _ints(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _paged(self, tokens, block_tbl, pos, n_new, sample_greedy: bool):
        out, self._paged_kv = M.paged_decode_step(
            self.params, self.paged_kv, self._ints(block_tbl),
            self._ints(pos), self._ints(tokens), self._ints(n_new), self.cfg,
            sample_greedy=sample_greedy, attn_impl=self.scfg.attn_impl,
            tp=self.tp)
        return out

    def step_paged(self, tokens: np.ndarray, block_tbl: np.ndarray,
                   pos: np.ndarray, n_new: np.ndarray) -> np.ndarray:
        """One chunked paged step: the greedy next token per slot."""
        return self._paged(tokens, block_tbl, pos, n_new,
                           sample_greedy=True).cpu().numpy()

    def step_paged_logits(self, tokens: np.ndarray, block_tbl: np.ndarray,
                          pos: np.ndarray, n_new: np.ndarray) -> torch.Tensor:
        """One chunked paged step: float32 logits ``[B, Vp]`` at each
        slot's last position, on the device (the sampling path)."""
        return self._paged(tokens, block_tbl, pos, n_new,
                           sample_greedy=False)

    # ------------------------------------------------------------ admission
    def admit(self, features: np.ndarray) -> np.ndarray:
        """Planter gate on request features -> keep mask (True = admit),
        one gate call for the whole feature matrix."""
        if self.gate_fn is None:
            return np.ones(len(features), bool)
        x = torch.as_tensor(np.asarray(features).astype(np.int32),
                            device=self.device)
        labels = self.gate_fn(x).cpu().numpy()
        return labels != self.scfg.gate_action_drop


class _FusedStep:
    """One shape key's fused paged serve step over static device buffers.

    The JAX package's ``_make_run_k_paged`` one_step on torch tensors:
    fill with page reservation and FIFO blocking, in-wave sharing waits,
    copy-on-write, the chunk build, the in-step gate, the greedy or
    sampled decode (with ``spec_k``: the draft chain ``d_1 = T[last]``,
    ``d_{j+1} = T[d_j]`` and its verify in the same launch, greedy by the
    longest matching prefix, sampled by rejection sampling), and eviction
    with refcount release and prefix holds.  Every tensor it reads or writes
    lives at a fixed address (the queue ``q``, the slot state ``st``, the
    batcher's page pool and the parameters), and it never makes the host
    wait, so on the card one step is captured once as a CUDA graph and
    replayed.

    The JAX step skips the decode with ``lax.cond`` when no slot is
    active; here the step always runs: with no active slot every chunk
    length is 0, every write drops and every update is masked, so it is
    the identity (``alive`` latches False and ``n_work`` does not count
    it; ``more`` tells the host whether the next step can have work, so
    it skips a round that could only idle).  JAX's ``mode="drop"``
    scatters go to one spare trailing row of the state tensor (``pref``
    row ``N``, the output rows ``R``, ``wdone`` row ``Nq``), which nothing
    reads; the page pool's writes drop through ``nn.attention.drop_plan``
    and ``put_rows``.  Besides the JAX step, a recorded token outside the
    vocabulary quarantines its slot at once (the host batcher's rule): it
    is evicted without registering its prefix and flagged in
    ``out_quar``; ``out_at`` orders the in-step drops by (step, slot) for
    the host's drop list.
    """

    def __init__(self, b: "DeviceContinuousBatcher", Nq: int, R: int,
                 n_feat: int, p_max: int, gated: bool, spec_k: int):
        scfg = b.engine.scfg
        dev = b.engine.device
        B, N, n_ps = scfg.max_batch, scfg.n_pages, scfg.pages_per_slot
        self.b, self.Nq, self.R, self.p_max = b, Nq, R, p_max
        self.spec_k = spec_k
        self.gate_fn = b.engine.gate_fn if gated else None

        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        def flag(*shape):
            return torch.zeros(shape, dtype=torch.bool, device=dev)

        self.q = dict(tok=i32(Nq, p_max), len=i32(Nq), req=i32(Nq),
                      feat=i32(Nq, n_feat), hasf=flag(Nq), sh=i32(Nq, n_ps),
                      dem=i32(Nq), start=i32(Nq), cow=i32(Nq), reg=flag(Nq),
                      seed=i32(Nq), wsrc=i32(Nq), wneed=i32(Nq), n=i32())
        self.st = dict(
            free=flag(B), req=i32(B), gen=i32(B), last=i32(B),
            feat=i32(B, n_feat), hasf=flag(B), seed=i32(B), head=i32(),
            pos=i32(B), plen=i32(B), pbuf=i32(B, p_max), tbl=i32(B, n_ps),
            reg=flag(B), qidx=i32(B), pref=i32(N + 1), wdone=flag(Nq + 1),
            out_tok=i32(R + 1, b.max_tokens), out_len=i32(R + 1),
            out_done=flag(R + 1), out_drop=flag(R + 1),
            out_quar=flag(R + 1), out_at=i32(R + 1),
            out_tbl=i32(R + 1, n_ps), alive=flag(), more=flag(),
            n_work=i32(), spec_prop=i32(), spec_acc=i32())
        self.graph = None

    # ------------------------------------------------------------ host
    def place(self, mesh) -> None:
        """The JAX batcher's ``device_put`` of its slot pytree and queue:
        the slot state by ``serve_state_shardings``, the queue rows by
        ``queue_pspec``.  On logical chips each buffer is validated and
        stays where it is, at its address (a captured step reads it)."""
        self.st = SH.place(self.st, SH.serve_state_shardings(
            self.st, mesh, self.b._B))
        self.q = {k: v if k == "n" else SH.NamedSharding(
            mesh, SH.queue_pspec(mesh, self.Nq, v.dim())).place(v)
            for k, v in self.q.items()}

    def write(self, queue: Dict[str, np.ndarray],
              state: Dict[str, np.ndarray]) -> None:
        """Copy host arrays into the leading rows of the buffers (between
        rounds only: a wave's queue and slot state, or a drain's
        evictions); on a mesh each array is validated first, as the JAX
        batcher places its queue and slot updates."""
        mesh = self.b.mesh
        if mesh is not None:
            for name, a in queue.items():
                if name != "n":
                    SH.NamedSharding(mesh, SH.queue_pspec(
                        mesh, len(a), np.ndim(a))).check(np.shape(a))
            for name, a in state.items():
                SH.NamedSharding(mesh, SH.serve_pspec(
                    name, a, mesh, self.b._B)).check(np.shape(a))
        for bufs, arrays in ((self.q, queue), (self.st, state)):
            for name, a in arrays.items():
                buf = bufs[name]
                a = torch.from_numpy(np.array(a, order="C"))
                (buf[: len(a)] if buf.dim() else buf).copy_(a)

    def reset(self) -> None:
        """Empty the output rings and counters for a new wave."""
        st = self.st
        for name in ("head", "out_len", "out_done", "out_drop", "out_quar",
                     "out_at", "n_work", "wdone", "spec_prop", "spec_acc"):
            st[name].zero_()
        st["out_tbl"].fill_(self.b.engine.scfg.n_pages)

    def read(self, *names: str) -> Dict[str, np.ndarray]:
        """Copies of the named state buffers on the host (never views of
        them: on the CPU ``.numpy()`` would share the buffer that the next
        wave's ``reset`` clears, under a traced run's deferred emission)."""
        return {n: self.st[n].cpu().numpy().copy() for n in names}

    def run(self, k: int) -> None:
        """``k`` fused steps: graph replays on the card, else eager."""
        self.st["alive"].fill_(True)
        for _ in range(k):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.step()

    def capture(self) -> None:
        """Capture one step as a CUDA graph.  A warm-up step runs eagerly
        first, on a side stream, from the idle state (every slot free, an
        empty queue), where it is the identity: it loads the kernels and
        settles the allocator before capture.  Over NCCL ranks one
        collective runs first, so that the communicator exists before the
        capture, and the step's gathers are captured with it; every rank
        captures the same step at the same point of its run.  Python's garbage collector
        runs just before the capture and is off during it: a dead batcher
        is a reference cycle (its steps hold it), and collecting one
        mid-capture destroys its graphs, a call that invalidates the
        capture (ROADMAP C.12); other threads' calls (the profiler's) do
        not count against it (``capture_error_mode="thread_local"``)."""
        st = self.st
        st["free"].fill_(True)
        self.q["n"].zero_()
        mesh = self.b.mesh
        if isinstance(mesh, SH.RankMesh):
            # the communicator is built before the capture, by every rank
            comm.warm_up(st["free"].device, mesh.group)
        side = torch.cuda.Stream(device=st["free"].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.step()
        finally:
            if collecting:
                gc.enable()
        self.graph = graph

    # ------------------------------------------------------------- step
    def step(self) -> None:
        b = self.b
        eng, scfg = b.engine, b.engine.scfg
        q, st = self.q, self.st
        Nq, R, p_max = self.Nq, self.R, self.p_max
        N, n_ps, page = scfg.n_pages, scfg.pages_per_slot, scfg.page_size
        C, share = b.prefill_chunk, scfg.share_prefix
        free, pref = st["free"], st["pref"]
        dev = free.device
        B = free.shape[0]
        slots = torch.arange(B, device=dev)
        jp = torch.arange(n_ps, device=dev)[None]

        # --- fill + page reservation (FIFO, ascending slot index)
        rank = torch.cumsum(free.to(torch.int32), 0) - 1
        cand = st["head"] + rank
        idx = cand.clamp(0, Nq - 1)
        in_q = free & (cand < q["n"])
        if share:
            # an in-wave reader waits until its writer (queue index
            # ``wsrc``) has reached ``wneed`` tokens or finished; a
            # blocked entry blocks everything behind it
            wsrc, wneed = q["wsrc"][idx], q["wneed"][idx]
            live_ok = ((~free)[None, :]
                       & (st["qidx"][None, :] == wsrc[:, None])
                       & (st["pos"][None, :] >= wneed[:, None])).any(1)
            wait_ok = ((wsrc < 0) | st["wdone"][wsrc.clamp(0, Nq - 1).long()]
                       | live_ok)
            ok = torch.cumprod(torch.where(in_q, wait_ok, True)
                               .to(torch.int32), 0).bool()
            in_q = in_q & ok
        # own-page demand against the free pages; lowest free pages first
        d = torch.where(in_q, q["dem"][idx], 0)
        take = in_q & (torch.cumsum(d, 0) <= (pref[:N] == 0).sum())
        d = torch.where(take, d, 0)
        need = jp < d[:, None]
        r = (torch.cumsum(need.reshape(-1).to(torch.int32), 0) - 1).clamp(
            0, N - 1)
        pg = torch.argsort((pref[:N] != 0).to(torch.int32), stable=True)[r]
        own = torch.where(need, pg.reshape(B, n_ps).to(torch.int32), N)
        # table: shared prefix pages first, own pages after
        qsh = q["sh"][idx]
        nsh = torch.where(take, (qsh < N).sum(1), 0)
        own_shift = torch.gather(own, 1,
                                 (jp - nsh[:, None]).clamp(0, n_ps - 1))
        tbl_new = torch.where(jp < nsh[:, None], qsh, own_shift)
        tbl_new = torch.where(jp < (nsh + d)[:, None], tbl_new, N)
        pref = pref.scatter_add(
            0, torch.where(take[:, None] & (tbl_new < N), tbl_new, N)
            .reshape(-1).long(), torch.ones((B * n_ps,), dtype=torch.int32,
                                            device=dev))
        if share:
            # copy-on-write: the first own page starts as a copy of the
            # partially matching cached page
            csrc = torch.where(take, q["cow"][idx], N)
            cdst = torch.where(
                csrc < N, torch.gather(tbl_new, 1, nsh.clamp(0, n_ps - 1)
                                       [:, None])[:, 0], N)
            plan = A.drop_plan(cdst, N)
            for pool in b._pages.pools():
                A.put_rows(pool, 1, plan, pool.index_select(
                    1, csrc.clamp(0, N - 1).long()))
        take2 = take[:, None]
        qidx = torch.where(take, idx.to(torch.int32), st["qidx"])
        req = torch.where(take, q["req"][idx], st["req"])
        plen = torch.where(take, q["len"][idx], st["plen"])
        pos = torch.where(take, q["start"][idx], st["pos"])
        pbuf = torch.where(take2, q["tok"][idx], st["pbuf"])
        last = torch.where(take, 0, st["last"])
        feat = torch.where(take2, q["feat"][idx], st["feat"])
        hasf = torch.where(take, q["hasf"][idx], st["hasf"])
        gen = torch.where(take, 0, st["gen"])
        reg = torch.where(take, q["reg"][idx], st["reg"])
        seed = torch.where(take, q["seed"][idx], st["seed"])
        free = free & ~take
        head = st["head"] + take.sum()
        tbl = torch.where(take2, tbl_new, st["tbl"])
        active = ~free
        work = active.any()

        # --- chunk build: up to C prompt tokens, else the last token (with
        # spec_k, a decoding slot's draft chain of up to spec_k + 1 tokens,
        # capped so that an all-accept step never passes max_tokens)
        SK = self.spec_k
        Call = max(C, SK + 1) if SK else C  # the launch's chunk width
        rem = plen - pos
        prefilling = active & (rem > 0)
        decoding = active & ~prefilling
        c_dec = ((b.max_tokens - gen).clamp(1, SK + 1) if SK
                 else torch.ones_like(gen))
        c = torch.where(active, torch.where(prefilling, rem.clamp(max=C),
                                            c_dec), 0)
        jc = torch.arange(Call, device=dev)[None]
        ptoks = torch.gather(pbuf, 1, (pos[:, None] + jc).clamp(0, p_max - 1))
        if SK:
            drafts = [last]
            for _ in range(Call - 1):
                drafts.append(b._draft_tbl[drafts[-1].clamp(
                    0, b._vocab - 1).long()])
            chunk = torch.where(prefilling[:, None], ptoks,
                                torch.stack(drafts, 1))
        else:
            chunk = torch.where(prefilling[:, None], ptoks,
                                torch.where(jc == 0, last[:, None], 0))
        chunk = torch.where(jc < c[:, None], chunk, 0)
        # --- the in-step gate: its verdict evicts a slot before its
        # first token is recorded
        if self.gate_fn is not None:
            labels = self.gate_fn(feat)
            gdrop = active & hasf & (labels == scfg.gate_action_drop)
        else:
            gdrop = torch.zeros_like(free)
        # --- decode: E [B, Call] are the tokens a slot emits this step,
        # ``me`` of them (a prefilling slot's last prompt position
        # predicts one)
        greedy = scfg.temperature == 0.0
        out, _ = M.paged_decode_step(
            eng.params, b._pages, tbl, pos, chunk, c, eng.cfg,
            sample_greedy=greedy, attn_impl=scfg.attn_impl,
            all_positions=bool(SK), tp=eng.tp)
        if not SK:
            nxt = out if greedy else S.sample_tokens(
                out, seed, gen, scfg.temperature, scfg.top_k, scfg.top_p)
            pos = pos + c
            live = active & (pos >= plen) & ~gdrop  # prompt consumed
            E, me = nxt[:, None], live.to(torch.int32)
        else:
            E, tok_first, acc = self._verify(out, chunk, c, decoding, seed,
                                             gen, jc)
            # emit the accepted drafts and one LM token, up to an EOS
            m0 = acc + 1
            eosj = torch.where((E == b.eos) & (jc < m0[:, None]), jc, Call)
            e1 = eosj.amin(1)
            m = torch.where(e1 < Call, torch.minimum(m0, e1 + 1),
                            m0).to(torch.int32)
            pos = torch.where(decoding, pos + m, pos + c)
            live = active & (pos >= plen) & ~gdrop
            me = torch.where(live, torch.where(decoding, m, 1), 0)
            E = torch.where(decoding[:, None], E, tok_first[:, None])
            spec = decoding & live
            st["spec_prop"].add_(torch.where(spec, c - 1, 0).sum()
                                 .to(torch.int32))
            st["spec_acc"].add_(torch.where(spec, acc, 0).sum()
                                .to(torch.int32))
        wide = jc[:, : E.shape[1]] < me[:, None]
        st["out_tok"].index_put_(
            (torch.where(wide, req[:, None], R).long(),
             (gen[:, None] + jc[:, : E.shape[1]]).clamp(
                 max=b.max_tokens - 1).long()), E)
        nxt = torch.gather(E, 1, (me - 1).clamp(min=0)[:, None].long())[:, 0]
        gen = gen + me
        bad = live & (wide & ((E < 0) | (E >= b._vocab))).any(1)
        fin = live & ~bad & ((gen >= b.max_tokens) | (nxt == b.eos))
        evict = gdrop | fin | bad
        # --- eviction: one reference off every table page, except a
        # completed ``reg`` slot's full-prompt pages (the prefix hold,
        # registered by the host at drain)
        hold = (reg & fin)[:, None] & (jp < (plen // page)[:, None])
        dec = evict[:, None] & (tbl < N) & ~hold
        pref = pref.scatter_add(
            0, torch.where(dec, tbl, N).reshape(-1).long(),
            torch.full((B * n_ps,), -1, dtype=torch.int32, device=dev))
        fidx = torch.where(fin, req, R).long()
        st["out_len"].index_put_((fidx,), gen)
        st["out_done"].index_fill_(0, fidx, True)
        st["out_tbl"].index_copy_(0, fidx, tbl)
        st["out_drop"].index_fill_(0, torch.where(gdrop, req, R).long(), True)
        st["out_quar"].index_fill_(0, torch.where(bad, req, R).long(), True)
        st["out_at"].index_put_(
            (torch.where(gdrop | bad, req, R).long(),),
            (st["n_work"] * B + slots).to(torch.int32))
        if share:
            st["wdone"].index_fill_(
                0, torch.where(fin & (qidx >= 0), qidx, Nq).long(), True)
        new = dict(free=free | evict, req=req, gen=gen,
                   last=torch.where(live, nxt, last), feat=feat, hasf=hasf,
                   seed=seed, head=head, pos=pos, plen=plen, pbuf=pbuf,
                   tbl=torch.where(evict[:, None], N, tbl), reg=reg,
                   qidx=qidx, pref=pref)
        for name, val in new.items():
            st[name].copy_(val)
        st["alive"].logical_and_(work)
        st["n_work"].add_(work.to(torch.int32))
        # whether the next step can have work: a live slot or an entry
        # left in the queue
        st["more"].copy_((~new["free"]).any() | (head < q["n"]))

    def _verify(self, out, chunk, c, decoding, seed, gen, jc):
        """Speculative verify of every slot's chunk: (E [B, Call] the
        tokens to emit, the first token of a prefilling slot, the accepted
        draft count).  Greedy (``out`` the LM argmax at every position):
        the longest draft prefix that matches the argmax at the position
        before it, then the argmax after it, so the stream is plain greedy
        decode's.  Sampled (``out`` the logits): draft j is accepted with
        probability p(d_j) (``uniform(seed, gen + j, salt=1)``); at the
        first rejection the next token is drawn from p with the rejected
        draft masked out (salt 2), after a full accept the bonus token from
        p (salt 0), so each token's marginal is the LM's."""
        scfg = self.b.engine.scfg
        Call = chunk.shape[1]
        jm = jc[:, : Call - 1]
        if scfg.temperature == 0.0:
            match = (chunk[:, 1:] == out[:, :-1]) & (jm < (c - 1)[:, None])
            acc = torch.cumprod(match.to(torch.int32), 1).sum(1)
            first = torch.gather(out, 1, (c - 1).clamp(0, Call - 1)
                                 [:, None].long())[:, 0]
            return out, first, acc.to(torch.int32)
        t, k, p = scfg.temperature, scfg.top_k, scfg.top_p
        probs = S.token_probs(out, t, k, p)
        Vp = probs.shape[-1]
        u = S.uniform(seed[:, None], gen[:, None] + jm, salt=1)
        p_acc = torch.gather(probs[:, :-1], 2, chunk[:, 1:, None].clamp(
            0, Vp - 1).long())[..., 0]
        amask = (u < p_acc) & (jm < (c - 1)[:, None])
        acc = torch.cumprod(amask.to(torch.int32), 1).sum(1).to(torch.int32)
        full = acc >= c - 1
        at = torch.where(decoding, acc.clamp(0, Call - 1),
                         (c - 1).clamp(0, Call - 1)).long()
        pick = at[:, None, None].expand(-1, 1, Vp)
        l_fin = torch.gather(out, 1, pick)[:, 0]
        p_fin = torch.gather(probs, 1, pick)[:, 0]
        kpos = gen + torch.where(decoding, acc, 0)
        bonus = S.sample_tokens(l_fin, seed, kpos, t, k, p)
        x_rej = torch.gather(chunk, 1, (acc + 1).clamp(0, Call - 1)
                             [:, None].long())[:, 0]
        lanes = torch.arange(Vp, device=out.device)[None]
        p_masked = torch.where(lanes == x_rej[:, None], 0.0, p_fin)
        resamp = S.categorical(p_masked, seed, kpos, salt=2)
        final = torch.where(decoding & ~full, resamp, bonus)
        dshift = torch.cat([chunk[:, 1:], torch.zeros_like(chunk[:, :1])], 1)
        E = torch.where(jc < acc[:, None], dshift, 0)
        E = torch.where(jc == acc[:, None], final[:, None], E)
        return E, final, acc


class _DenseStep(_FusedStep):
    """One shape key's fused step over the dense ring cache: the JAX
    package's ``_make_run_k`` one_step on torch tensors.  Fill freed slots
    from the queue (FIFO, ascending slot), the in-step gate, one
    ``decode_step`` of every slot at the global position (a free slot feeds
    token 0), greedy or sampled, and eviction.  The cache and ``pos`` are
    the batcher's decode state, written in place.

    The JAX step skips the decode with ``lax.cond`` when no slot works;
    this one always runs and hands ``decode_step`` the device flag
    ``commit`` instead: with no work every cache write drops and ``pos``
    stays, so the step is the identity and never makes the host wait.  As
    in the paged step, a recorded token outside the vocabulary
    quarantines its slot at once."""

    def __init__(self, b: "DeviceContinuousBatcher", Nq: int, R: int,
                 n_feat: int, gated: bool):
        dev = b.engine.device
        B = b.engine.scfg.max_batch
        self.b, self.Nq, self.R = b, Nq, R
        self.gate_fn = b.engine.gate_fn if gated else None

        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        def flag(*shape):
            return torch.zeros(shape, dtype=torch.bool, device=dev)

        self.q = dict(tok=i32(Nq), req=i32(Nq), feat=i32(Nq, n_feat),
                      hasf=flag(Nq), seed=i32(Nq), n=i32())
        self.st = dict(
            free=flag(B), req=i32(B), gen=i32(B), last=i32(B),
            feat=i32(B, n_feat), hasf=flag(B), seed=i32(B), head=i32(),
            out_tok=i32(R + 1, b.max_tokens), out_len=i32(R + 1),
            out_done=flag(R + 1), out_drop=flag(R + 1),
            out_quar=flag(R + 1), out_at=i32(R + 1), alive=flag(),
            more=flag(), n_work=i32())
        self.graph = None

    def reset(self) -> None:
        for name in ("head", "out_len", "out_done", "out_drop", "out_quar",
                     "out_at", "n_work"):
            self.st[name].zero_()

    def step(self) -> None:
        b = self.b
        eng, scfg = b.engine, b.engine.scfg
        q, st = self.q, self.st
        Nq, R = self.Nq, self.R
        free = st["free"]
        B = free.shape[0]
        slots = torch.arange(B, device=free.device)

        # --- fill (FIFO, ascending slot index)
        rank = torch.cumsum(free.to(torch.int32), 0) - 1
        cand = st["head"] + rank
        take = free & (cand < q["n"])
        idx = cand.clamp(0, Nq - 1)
        req = torch.where(take, q["req"][idx], st["req"])
        last = torch.where(take, q["tok"][idx], st["last"])
        feat = torch.where(take[:, None], q["feat"][idx], st["feat"])
        hasf = torch.where(take, q["hasf"][idx], st["hasf"])
        seed = torch.where(take, q["seed"][idx], st["seed"])
        gen = torch.where(take, 0, st["gen"])
        free = free & ~take
        head = st["head"] + take.sum()
        active = ~free
        work = active.any()
        # --- the in-step gate: its verdict evicts a slot before its first
        # token is recorded
        if self.gate_fn is not None:
            labels = self.gate_fn(feat)
            gdrop = active & hasf & (labels == scfg.gate_action_drop)
        else:
            gdrop = torch.zeros_like(free)
        # --- decode every slot at the global position; no work: identity
        greedy = scfg.temperature == 0.0
        tok = torch.where(free, 0, last)[:, None]
        out, _ = M.decode_step(eng.params, b._decode, tok, eng.cfg,
                               sample_greedy=greedy,
                               attn_impl=scfg.attn_impl, commit=work,
                               tp=eng.tp)
        nxt = out if greedy else S.sample_tokens(
            out, seed, gen, scfg.temperature, scfg.top_k, scfg.top_p)
        live = active & ~gdrop
        st["out_tok"].index_put_(
            (torch.where(live, req, R).long(),
             gen.clamp(max=b.max_tokens - 1).long()), nxt)
        gen = gen + live.to(torch.int32)
        bad = live & ((nxt < 0) | (nxt >= b._vocab))
        fin = live & ~bad & ((gen >= b.max_tokens) | (nxt == b.eos))
        evict = gdrop | fin | bad
        fidx = torch.where(fin, req, R).long()
        st["out_len"].index_put_((fidx,), gen)
        st["out_done"].index_fill_(0, fidx, True)
        st["out_drop"].index_fill_(0, torch.where(gdrop, req, R).long(), True)
        st["out_quar"].index_fill_(0, torch.where(bad, req, R).long(), True)
        st["out_at"].index_put_(
            (torch.where(gdrop | bad, req, R).long(),),
            (st["n_work"] * B + slots).to(torch.int32))
        new = dict(free=free | evict, req=req, gen=gen,
                   last=torch.where(live, nxt, last), feat=feat, hasf=hasf,
                   seed=seed, head=head)
        for name, val in new.items():
            st[name].copy_(val)
        st["alive"].logical_and_(work)
        st["n_work"].add_(work.to(torch.int32))
        st["more"].copy_((~new["free"]).any() | (head < q["n"]))


class DeviceContinuousBatcher:
    """Device-resident continuous batching over the paged cache: the slot
    state lives on the device and fill -> gate -> decode -> sample ->
    evict is one fused step, run ``sync_every`` steps per host round trip
    (mirrors the paged mode of ``repro.serve.engine``).

    The host reads a done mask and an ``alive`` flag once a round, builds
    waves (one batched gate launch over the waiting queue with
    ``pregate``, the prefix-trie plan, in-wave cold prefix sharing) and
    drains finished requests.  On the card each shape key's step is a
    CUDA graph replayed ``min(sync_every, steps left)`` times a round;
    ``graph=False`` runs the same step eagerly (no effect on the CPU).  A
    round that drains early still runs its remaining steps as identity
    steps: ``steps`` counts the steps that had work (the host batcher's
    count), ``steps_executed`` every step run, and their difference is
    ``steps_wasted``.

    ``run(max_steps=...)`` is resumable: in-flight slots are carried over
    and un-admitted queue entries re-enqueued.  Deadlines are checked at
    admission and evict at drain boundaries; a queue-full submission
    retries with backoff (``max_retries``).  A recorded token outside the
    vocabulary quarantines its request in the step that records it, as
    the host batcher does (the JAX device batcher checks only under a
    fault injector, at drain).

    ``spec_k`` with a compiled ``draft`` (``serve.spec``) drafts up to
    ``spec_k`` tokens a decoding slot inside the step and verifies the
    chain in the same chunked launch; ``spec_stats()`` reads the step's
    counters after each ``run()``.  ``tracer``/``metrics`` (``obs``) and
    ``fault_injector`` (``serve.faults``) act at drain boundaries only: a
    traced run replays the fill schedule on the host from the drained
    state (its timestamps interpolated between the boundaries), so the
    captured step is the untraced one, and without a tracer, an injector,
    a deadline or a held page the drive loop is unchanged.  ``mesh``
    (default: the engine's) places the page pool or the decode cache, the
    slot state and the queue on its logical chips (the module docstring):
    the same buffers and graphs, the same streams.  The router
    (``serve.router``) drives several batchers.

    Over an engine without ``page_size`` (the dense mode) the batcher owns
    a dense decode state and runs ``_DenseStep``: one global position, one
    token a slot a step, single-token prompts (a longer one is refused at
    ``submit``), no page pool (``pool`` is None, ``PoolExhaust`` never
    fires); ``spec_k`` needs the paged cache.
    """

    def __init__(self, engine: ServeEngine, eos_token: int = 0,
                 max_tokens: int = 32, sync_every: int = 8,
                 pregate: bool = True, mesh=None,
                 prefill_chunk: int = 1, max_queue: Optional[int] = None,
                 tracer=None, metrics=None, max_retries: int = 0,
                 retry_backoff: int = 1,
                 deadline_s: Optional[float] = None,
                 fault_injector=None,
                 clock: Callable[[], float] = time.perf_counter,
                 spec_k: int = 0, draft=None, graph: bool = True):
        self.engine = engine
        # the engine's mesh unless the caller gives another
        self.mesh = engine.mesh if mesh is None else mesh
        if self.mesh is not None:
            _check_mesh(self.mesh, engine.device)
        self.eos = int(eos_token)
        self.max_tokens = int(max_tokens)
        self.sync_every = max(1, int(sync_every))
        self.pregate = pregate
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.max_queue = max_queue
        self.spec_k = int(spec_k)
        self.draft = draft
        self._draft_tbl = None
        if self.spec_k:
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if not engine.scfg.paged:
                raise ValueError(
                    "speculative decoding verifies drafts through the "
                    "chunked paged step: set ServeConfig(page_size=...)")
            if draft is None:
                raise ValueError(
                    "spec_k > 0 needs a compiled draft model "
                    "(serve.spec.train_draft / compile_draft)")
            if draft.vocab_size < engine.cfg.vocab_size:
                raise ValueError(
                    f"draft table covers {draft.vocab_size} tokens but "
                    f"the LM vocab is {engine.cfg.vocab_size}")
            self._draft_tbl = draft.device_table(engine.device)
        self._spec_prop = 0
        self._spec_acc = 0
        self.max_retries = int(max_retries)
        self.retry_backoff = max(1, int(retry_backoff))
        self.default_deadline_s = deadline_s
        self.injector = fault_injector
        self._clock = clock
        self._now = _decision_clock(self.mesh, clock)
        self._drains = 0
        self._retry_q: collections.deque = collections.deque()
        self._exh_holds: List[list] = []  # [due drain, held page ids]
        self._host_drops: Dict[int, Tuple[int, str, float]] = {}
        self._vocab = engine.cfg.vocab_size
        # gloo's collectives do not capture: over gloo ranks the step runs
        # eagerly
        self.graph = (bool(graph) and engine.device.type == "cuda"
                      and not (isinstance(self.mesh, SH.RankMesh)
                               and comm.placement().backend != "nccl"))
        scfg = engine.scfg
        self._B = scfg.max_batch
        self.paged = scfg.paged
        self.pool = None
        if self.paged:
            # the batcher's own page pool (fixed addresses: a captured
            # step writes it in place) and its host mirror with the
            # prefix trie
            self._pages = M.init_paged_kv(engine.cfg, scfg.n_pages,
                                          scfg.page_size,
                                          kv_dtype=scfg.kv_dtype,
                                          device=engine.device,
                                          mesh=self.mesh, tp=engine.tp)
            self.pool = scfg.make_pool()
        else:
            # the batcher's own dense decode state, ``pos`` included, at
            # fixed addresses
            self._decode = M.init_decode_state(engine.cfg, scfg.max_batch,
                                               scfg.cache_len,
                                               device=engine.device,
                                               mesh=self.mesh, tp=engine.tp)
        self.seeds: dict = {}
        self.queue: collections.deque = collections.deque()
        self.done: dict = {}
        self.done_at: dict = {}
        self.dropped: list = []
        self.drop_reasons: dict = {}
        self.dropped_at: dict = {}
        self.deadline: dict = {}  # request_id -> absolute deadline
        # per-slot carryover of a max_steps-bounded run
        self._carry: List[Optional[dict]] = [None] * self._B
        self._steps: Dict[Tuple, _FusedStep] = {}
        self.steps = 0  # fused steps that had an active slot
        self.steps_executed = 0  # fused steps run (graph replays or eager)
        self.tracer = None
        self.metrics = None
        self.trace_shard = 0
        # steps across run() calls: trace events carry absolute steps
        self._steps_total = 0
        self.attach_obs(tracer, metrics)

    @property
    def steps_wasted(self) -> int:
        """Identity steps run after a round's work ran out."""
        return self.steps_executed - self.steps

    def attach_obs(self, tracer=None, metrics=None) -> None:
        """Attach an ``obs`` Tracer/Metrics pair (None detaches).  The
        fused step is the same either way: lifecycles are replayed on the
        host after each run."""
        _attach_obs(self, tracer, metrics)

    def spec_stats(self) -> dict:
        """Speculative decoding so far: drafted tokens, accepted tokens
        and the acceptance rate."""
        prop = int(self._spec_prop)
        return {"spec_k": self.spec_k, "drafted": prop,
                "accepted": int(self._spec_acc),
                "acceptance_rate": (self._spec_acc / prop) if prop else 0.0}

    def submit(self, request_id, prompt_tokens,
               features: Optional[np.ndarray] = None,
               deadline_s: Optional[float] = None,
               seed: Optional[int] = None):
        """Enqueue; admission happens batched in ``run()``.  ``deadline_s``
        bounds queue + serve time; ``seed`` keys the sampling noise."""
        self.seeds[request_id] = (int(seed) if seed is not None
                                  else _default_seed(request_id))
        prompt = _submit_traced(self, request_id, prompt_tokens, False)
        ddl = deadline_s if deadline_s is not None else self.default_deadline_s
        dabs = None
        if ddl is not None:
            if ddl <= 0:
                _drop_request(self, request_id, "deadline")
                return False
            dabs = self._now() + float(ddl)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            feat_n = None if features is None else np.asarray(features)
            if self.max_retries > 0:
                _defer_full(self, request_id, prompt, feat_n, dabs)
                return True
            _drop_request(self, request_id, "queue-full")
            return False
        if dabs is not None:
            self.deadline[request_id] = dabs
        self.queue.append((request_id, prompt,
                           None if features is None else np.asarray(features)))
        return True

    def pending_work(self) -> int:
        """Un-served load: queued entries + backed-off retries + in-flight
        carryover slots."""
        return (len(self.queue) + len(self._retry_q)
                + sum(c is not None for c in self._carry))

    def abandon(self) -> None:
        """Stop reporting work (the router's failover of a dead shard):
        the queue, the retry queue and the carried slots are dropped on the
        host; the slot state on the device is never read again."""
        self.queue.clear()
        self._retry_q.clear()
        self._carry = [None] * self._B

    @property
    def _pfree(self) -> np.ndarray:
        """Free-page view over the refcounted pool mirror."""
        return self.pool.ref == 0

    def _fused(self, key: Tuple) -> _FusedStep:
        fs = self._steps.get(key)
        if fs is None:
            step = _FusedStep if self.paged else _DenseStep
            fs = self._steps[key] = step(self, *key)
            if self.mesh is not None:
                fs.place(self.mesh)
            if self.graph:
                fs.capture()
        return fs

    def _apply_drain_faults(self, fs: _FusedStep, req_ids: list, now: float,
                            steps_run: int, traced: bool) -> list:
        """One drain boundary's faults (the JAX batcher's
        ``_apply_drain_faults``): an injected corruption of a slot's last
        token and the finite check that quarantines it, deadline
        eviction, and ``PoolExhaust`` holds on every free page.  Only the
        host-rebuildable state (``free``, ``tbl``, ``pref``) is written,
        between rounds.  Returns the ``(step, slots, pages)`` releases a
        traced run's replay folds in."""
        inj = self.injector
        shard = self.trace_shard
        drain = self._drains - 1  # the boundary just completed
        B = self._B
        NP = self.engine.scfg.n_pages if self.paged else 0
        host = fs.read("free", "req", "gen",
                       *(("tbl", "pref") if self.paged else ()),
                       *(("out_tok",) if inj is not None else ()))
        free, req, gen = host["free"].copy(), host["req"], host["gen"]
        evict: Dict[int, str] = {}
        if inj is not None:
            out_tok = host["out_tok"].copy()
            for ev in inj.corruptions(shard, drain):
                b = ev.slot
                if b < B and not free[b] and gen[b] > 0:
                    out_tok[int(req[b]), min(int(gen[b]) - 1,
                                             self.max_tokens - 1)] = ev.value
            # the finite check: an out-of-range last token is a poisoned
            # sample, and exactly that slot is quarantined
            for b in range(B):
                if free[b] or gen[b] == 0:
                    continue
                t = int(out_tok[int(req[b]), min(int(gen[b]) - 1,
                                                 self.max_tokens - 1)])
                if not 0 <= t < self._vocab:
                    evict[b] = "quarantined"
        if self.deadline:
            for b in range(B):
                if free[b] or b in evict or int(req[b]) >= len(req_ids):
                    continue
                dabs = self.deadline.get(req_ids[int(req[b])])
                if dabs is not None and now > dabs:
                    evict[b] = "deadline"
        upd: Dict[str, np.ndarray] = {}
        events: List[Tuple[int, int, int]] = []
        pref = None
        if evict:
            if self.paged:
                tbl, pref = host["tbl"].copy(), host["pref"].copy()
            for b, reason in evict.items():
                qi = int(req[b])
                free[b] = True
                pages = 0
                if self.paged:
                    valid = tbl[b][tbl[b] < NP]
                    np.subtract.at(pref, valid, 1)
                    pages = int((pref[valid] == 0).sum())
                    tbl[b] = NP
                _drop_request(self, req_ids[qi], reason, now,
                              trace=not traced)
                if traced:
                    self._host_drops[qi] = (steps_run, reason, now)
                    events.append((steps_run + 1, 1, pages))
            upd["free"] = free
            if self.paged:
                upd["tbl"] = tbl
        if inj is not None and self.paged:
            for ev in inj.exhaustions(shard, drain):
                if pref is None:
                    pref = host["pref"].copy()
                held = np.where(pref[:NP] == 0)[0]
                pref[held] += 1
                self._exh_holds.append([self._drains + ev.hold_drains, held])
        due = [h for h in self._exh_holds if h[0] <= self._drains]
        if due:
            if pref is None:
                pref = host["pref"].copy()
            for _, pages in due:
                pref[pages] -= 1
            self._exh_holds = [h for h in self._exh_holds
                               if h[0] > self._drains]
        if pref is not None:
            upd["pref"] = pref
        if upd:
            fs.write({}, upd)
        return events

    def run(self, max_steps: int = 1000) -> dict:
        """Decode until queue + slots drain (or ``max_steps``); returns
        {request_id: tokens}.  Unfinished work resumes on the next call."""
        _service_retries(self)
        pending = list(self.queue)
        self.queue.clear()
        carry = [(b, c) for b, c in enumerate(self._carry) if c is not None]
        if not pending and not carry:
            if self._retry_q:
                # an empty run() is one drain boundary: backoff elapses
                self._drains += 1
                _service_retries(self)
                pending = list(self.queue)
                self.queue.clear()
            if not pending:
                return self.done
        eng = self.engine
        scfg = eng.scfg
        traced = self.tracer is not None
        if traced and self.spec_k:
            raise ValueError(
                "speculative decoding is unsupported on a traced run: the "
                "schedule replay assumes one emitted token per decode "
                "step, which an accepted draft chain violates")
        # batched admission: one gate launch over the whole waiting queue
        keep = np.ones(len(pending), bool)
        gated = [i for i, (_, _, f) in enumerate(pending) if f is not None]
        if gated and eng.gate_fn is not None and self.pregate:
            keep[gated] = eng.admit(np.stack([pending[i][2] for i in gated]))
        req_ids: List = [c["rid"] for _, c in carry]
        kept: List[Tuple] = []
        now0 = self._now() if self.deadline else 0.0
        for k, (rid, prompt, feat) in enumerate(pending):
            dabs = self.deadline.get(rid)
            if dabs is not None and now0 > dabs:
                # an expired entry never enters the wave
                _drop_request(self, rid, "deadline", now0)
                continue
            if not keep[k]:
                _drop_request(self, rid, "gate-reject")
                continue
            req_ids.append(rid)
            kept.append((rid, prompt, feat))
        if not req_ids:
            return self.done
        C, n = len(carry), len(kept)
        feats = ([len(f) for _, _, f in kept if f is not None]
                 + [len(c["feat"]) for _, c in carry if c["feat"] is not None])
        n_feat = max(feats, default=1)
        # pow2 buckets bound the shape keys across queue sizes
        Nq = max(8, 1 << (max(1, n) - 1).bit_length())
        R = max(8, 1 << (C + n - 1).bit_length())
        paged = self.paged
        longest = max([len(p) for _, p, _ in kept]
                      + [len(c.get("prompt", ())) for _, c in carry] + [1])
        p_max = max(4, 1 << (longest - 1).bit_length())
        NP = scfg.n_pages if paged else 0
        n_ps = scfg.pages_per_slot if paged else 0
        # the dense queue holds one token an entry
        qtok = np.zeros((Nq, p_max) if paged else Nq, np.int32)
        qlen = np.zeros(Nq, np.int32)
        qsh = np.full((Nq, n_ps), NP, np.int32)
        qdem = np.zeros(Nq, np.int32)
        qstart = np.zeros(Nq, np.int32)
        qcow = np.full(Nq, NP, np.int32)
        qreg = np.zeros(Nq, bool)
        qwsrc = np.full(Nq, -1, np.int32)  # in-wave writer queue index
        qwneed = np.zeros(Nq, np.int32)  # tokens the writer must reach
        qreq = np.zeros(Nq, np.int32)
        qseed = np.zeros(Nq, np.int32)
        qfeat = np.zeros((Nq, n_feat), np.int32)
        qhasf = np.zeros(Nq, bool)
        if paged:
            self.pool.begin_wave()
        # qi -> (prompt, register-on-completion) for drain registration
        winfo: List[Tuple[list, bool]] = [
            (c.get("prompt", []), c.get("reg", False)) for _, c in carry]
        wplans: List = []  # kept index -> PagePlan (stats at drain)
        for k, (rid, prompt, f) in enumerate(kept):
            qseed[k] = self.seeds.get(rid, _default_seed(rid))
            qreq[k] = C + k  # output row: carryover rows come first
            if f is not None:
                qfeat[k, : len(f)] = f[:n_feat]
                qhasf[k] = True
            if not paged:
                qtok[k] = prompt[0]
                winfo.append(([], False))
                continue
            qtok[k, : len(prompt)] = prompt
            qlen[k] = len(prompt)
            # prefix-trie plan: shared pages, start, COW source, own demand
            plan = self.pool.plan(prompt, self.max_tokens)
            qsh[k, : len(plan.shared)] = plan.shared
            qdem[k] = plan.own
            qstart[k] = plan.start
            if plan.cow_src is not None:
                qcow[k] = plan.cow_src
            qreg[k] = plan.reg
            winfo.append((prompt, plan.reg))
            wplans.append(plan)
        wave_pins: List[int] = []  # host pins on in-wave shared pages
        wave_deps = False  # any reader waiting on an in-wave writer?
        if scfg.share_prefix:
            # pressure-release cached prefixes (LRU leaf-first) so the
            # wave's largest own demand can be met; pages the wave shares
            # are pinned
            keep_pin = set(int(p) for p in qsh[qsh < NP])
            keep_pin |= set(int(p) for p in qcow[qcow < NP])
            self.pool.ensure_free(int(qdem.max(initial=0)), keep_pin)
            if not traced:  # the replay does not model admission waits
                wave_pins, wave_deps = self._plan_in_wave(
                    kept, qsh, qdem, qstart, qcow, qwsrc, qwneed, wplans)

        B = self._B
        free = np.ones(B, bool)
        req = np.full(B, R, np.int32)
        gen = np.zeros(B, np.int32)
        last = np.zeros(B, np.int32)
        feat = np.zeros((B, n_feat), np.int32)
        hasf = np.zeros(B, bool)
        seed = np.zeros(B, np.int32)
        out_tok = np.zeros((R, self.max_tokens), np.int32)
        pos = np.zeros(B, np.int32)
        plen = np.zeros(B, np.int32)
        pbuf = np.zeros((B, p_max), np.int32)
        tbl = np.full((B, n_ps), NP, np.int32)
        reg = np.zeros(B, bool)
        for row, (b, c) in enumerate(carry):  # resume in-flight slots
            free[b] = False
            req[b] = row
            gen[b] = c["gen"]
            last[b] = c["last"]
            hasf[b] = c["hasf"]
            seed[b] = c.get("seed", _default_seed(c["rid"]))
            if c["feat"] is not None:
                feat[b, : len(c["feat"])] = c["feat"][:n_feat]
            out_tok[row, : c["gen"]] = c["toks"]
            if paged:
                pos[b] = c["pos"]
                plen[b] = len(c["prompt"])
                pbuf[b, : len(c["prompt"])] = c["prompt"]
                tbl[b] = c["tbl"]
                reg[b] = c.get("reg", False)
        pref0 = self.pool.ref.copy() if traced and paged else None
        queue = dict(tok=qtok, req=qreq, feat=qfeat, hasf=qhasf, seed=qseed,
                     n=np.asarray(n, np.int32))
        state = dict(free=free, req=req, gen=gen, last=last, feat=feat,
                     hasf=hasf, seed=seed, out_tok=out_tok)
        if paged:
            fs = self._fused((Nq, R, n_feat, p_max, bool(feats),
                              self.spec_k))
            queue.update(len=qlen, sh=qsh, dem=qdem, start=qstart, cow=qcow,
                         reg=qreg, wsrc=qwsrc, wneed=qwneed)
            state.update(pos=pos, plen=plen, pbuf=pbuf, tbl=tbl, reg=reg,
                         pref=self.pool.ref, qidx=np.full(B, -1, np.int32))
        else:
            fs = self._fused((Nq, R, n_feat, bool(feats)))
        fs.reset()
        fs.write(queue, state)

        inj = self.injector
        if (traced and inj is not None
                and inj.pending_kinds(self.trace_shard, PoolExhaust)):
            raise ValueError(
                "pool-exhaust injection is unsupported on a traced run: the "
                "schedule replay models page releases only at slot "
                "evictions, so phantom holds would make tracer spans lie")
        self._host_drops = {}
        fault_events: List[Tuple[int, int, int]] = []
        seen = np.zeros(R, bool)
        remaining = max_steps
        alive = True
        steps_run = 0
        # (step, host time) at each drain boundary: a traced run's events
        # get host times interpolated between them
        boundaries = [(0, self._clock())]
        while remaining > 0:
            k = min(self.sync_every, remaining)
            fs.run(k)
            self.steps_executed += k
            # the round's one read: the done mask and the flags
            flags = torch.cat([fs.st["out_done"][:R], fs.st["alive"].view(1),
                               fs.st["more"].view(1)]).cpu().numpy()
            done_mask, alive, more = flags[:R], bool(flags[R]), flags[R + 1]
            # a deadline decides by the slice's clock; else a stamp
            now = self._now() if self.deadline else self._clock()
            steps_run += k
            if traced:
                boundaries.append((steps_run, now))
            remaining -= k
            for qi in np.where(done_mask & ~seen)[0]:
                self.done_at[req_ids[qi]] = now
                self.deadline.pop(req_ids[qi], None)
                if traced:  # the done_at stamp
                    self.tracer.drained(req_ids[qi], t=now)
            seen = done_mask
            self._drains += 1
            # no injector, deadline or held page: the loop is the plain one
            if (self.deadline or self._exh_holds
                    or (inj is not None and inj.pending_for(self.trace_shard))):
                fault_events += self._apply_drain_faults(
                    fs, req_ids, now, steps_run, traced)
            if not alive:
                break
            if not more and remaining > 0:
                # the next round could only find no work: count its drain
                # boundary as the JAX loop does, without running it
                k = min(self.sync_every, remaining)
                now = self._now() if self.deadline else self._clock()
                steps_run += k
                if traced:
                    boundaries.append((steps_run, now))
                remaining -= k
                self._drains += 1
                if (self.deadline or self._exh_holds
                        or (inj is not None
                            and inj.pending_for(self.trace_shard))):
                    fault_events += self._apply_drain_faults(
                        fs, req_ids, now, steps_run, traced)
                alive = False
                break
        out = fs.read("head", "out_tok", "out_len", "out_drop", "out_quar",
                      "out_at", "n_work", "free", "req", "gen", "last",
                      "feat", "hasf", "seed",
                      *(("pref", "out_tbl", "pos", "plen", "pbuf", "tbl",
                         "reg", "spec_prop", "spec_acc") if paged else ()))
        self.steps += int(out["n_work"])
        head = int(out["head"])
        if paged:
            self._spec_prop += int(out["spec_prop"])
            self._spec_acc += int(out["spec_acc"])
            self.pool.ref[:] = out["pref"][:NP]
            if wave_pins:
                # drop the host pins on in-wave shared node pages
                np.subtract.at(self.pool.ref, np.asarray(wave_pins), 1)
            if self._exh_holds:
                # held pages never outlive the run
                for _, pages in self._exh_holds:
                    self.pool.ref[pages] -= 1
                self._exh_holds = []
            self.pool.observe_occupancy()
            # sharing stats: exactly the entries the step admitted
            for k in range(min(head, n)):
                self.pool.record_plan(wplans[k], len(kept[k][1]))
        if traced:
            self._replay(out, seen, carry, req_ids, pref0, qdem, qlen,
                         qstart, qsh, qreg, fault_events, boundaries,
                         steps_run, alive)
        drops = []
        for qi in range(C + n):
            if seen[qi]:
                self.done[req_ids[qi]] = [
                    int(t) for t in out["out_tok"][qi, : out["out_len"][qi]]]
                if winfo[qi][1]:
                    # the step kept one reference on the full-prompt
                    # pages: hand them to the prefix trie
                    prompt = winfo[qi][0]
                    nfp = len(prompt) // scfg.page_size
                    self.pool.register_completed(
                        prompt, [int(p) for p in out["out_tbl"][qi][:nfp]])
            elif out["out_drop"][qi] or out["out_quar"][qi]:
                drops.append(qi)
        # in-step drops in the order the step made them: (step, slot); a
        # traced run's tracer events come from the replay
        for qi in sorted(drops, key=lambda qi: out["out_at"][qi]):
            _drop_request(self, req_ids[qi], "quarantined"
                          if out["out_quar"][qi] else "gate-reject",
                          trace=False)
        self._carry = [None] * B
        if alive:
            for b in range(B):
                if out["free"][b]:
                    continue
                qi = int(out["req"][b])
                g = int(out["gen"][b])
                self._carry[b] = dict(
                    rid=req_ids[qi], gen=g, last=int(out["last"][b]),
                    hasf=bool(out["hasf"][b]),
                    feat=out["feat"][b].copy() if out["hasf"][b] else None,
                    seed=int(out["seed"][b]),
                    toks=out["out_tok"][qi, :g].copy())
                if paged:
                    self._carry[b].update(
                        pos=int(out["pos"][b]),
                        prompt=[int(t) for t in
                                out["pbuf"][b, : out["plen"][b]]],
                        tbl=out["tbl"][b].copy(), reg=bool(out["reg"][b]))
        # re-enqueue un-admitted entries regardless of the alive flag: a
        # reader blocked on a dead writer idles the step out while its
        # entry is still pending
        for entry in reversed(kept[head:]):
            self.queue.appendleft(entry)
        if (wave_deps and not alive and head > 0 and remaining > 0
                and self.queue):
            # in-wave readers waited on a writer that died: re-plan cold
            return self.run(remaining)
        return self.done

    def _replay(self, out, seen, carry, req_ids, pref0, qdem, qlen, qstart,
                qsh, qreg, fault_events, boundaries, steps_run,
                alive) -> None:
        """A traced run's request lifecycles, replayed on the host (the
        JAX batcher's schedule replay): the step's fill is a function of
        the FIFO queue, the free slots and the free pages, and an admitted
        slot advances every step until it is evicted, so from the drained
        outcomes the host finds each request's admit, first-token and
        terminal steps; steps map to host times by interpolation between
        the drain boundaries.  Besides the JAX replay, a request
        quarantined in the step (``out_quar``, at ``out_at``) ends there
        and frees its slot and pages.  Emission is deferred to the
        tracer's next read.  In dense mode there are no pages and a slot's
        first token comes on its admit step (fill and decode share it)."""
        eng = self.engine
        paged = self.paged
        B, page = self._B, eng.scfg.page_size
        NP = eng.scfg.n_pages if paged else 0
        Ck = self.prefill_chunk if paged else 1
        C, n = len(carry), len(req_ids) - len(carry)
        out_len, out_drop = out["out_len"], out["out_drop"]
        out_quar, out_at = out["out_quar"], out["out_at"]
        s_admit: List = [None] * (C + n)  # fresh admits only
        s_first: List = [None] * (C + n)
        s_done: List = [None] * (C + n)
        events: List[Tuple[int, int, int]] = []  # step, slots, pages
        for qi in range(C):
            # a resumed slot, occupied from step 1: its admit (and first
            # token) were reported by the run that saw them
            cst = carry[qi][1]
            g0 = int(cst["gen"])
            if paged and g0 == 0:  # resumed mid-prefill
                rem = len(cst["prompt"]) - int(cst["pos"])
                s_first[qi] = max(-(-rem // Ck), 1)
            if seen[qi]:
                s_done[qi] = (s_first[qi] + int(out_len[qi]) - 1
                              if s_first[qi] is not None
                              else int(out_len[qi]) - g0)
            elif out_drop[qi] or out_quar[qi]:
                s_done[qi] = int(out_at[qi]) // B + 1
            if s_done[qi] is not None:
                # pages released at eviction: those at refcount 1 when the
                # run started (shared pages keep the prefix cache's hold);
                # a completed reg slot keeps its full-prompt pages
                pages = 0
                if paged:
                    tbl_c = np.asarray(cst["tbl"])
                    own = ((tbl_c < NP)
                           & (pref0[np.clip(tbl_c, 0, NP - 1)] == 1))
                    if cst.get("reg", False) and seen[qi]:
                        own[: len(cst["prompt"]) // page] = False
                    pages = int(own.sum())
                heapq.heappush(events, (s_done[qi] + 1, 1, pages))
        for ev in fault_events:
            # host fault evictions free their slot and pages one step past
            # the drain boundary they fired at
            heapq.heappush(events, ev)
        free_slots = B - C
        free_pages = int((pref0 == 0).sum()) if paged else 0
        step, qp = 1, 0
        while qp < n and step <= steps_run:
            qi = C + qp
            dem = int(qdem[qp])
            if free_slots < 1 or dem > free_pages:
                # blocked: resources change only at evictions
                if not events:
                    break
                s2, sl, pg = heapq.heappop(events)
                if s2 > steps_run:
                    break
                step = max(step, s2)
                free_slots += sl
                free_pages += pg
                continue
            s_admit[qi] = step
            free_slots -= 1
            free_pages -= dem
            if out_drop[qi]:  # the gate's verdict evicts on the admit step
                s_done[qi] = step
                heapq.heappush(events, (step + 1, 1, dem))
            else:
                pre = -(-(int(qlen[qp]) - int(qstart[qp])) // Ck)
                s_first[qi] = step + max(pre, 1) - 1
                if seen[qi]:
                    s_done[qi] = s_first[qi] + int(out_len[qi]) - 1
                    held = 0
                    if qreg[qp]:
                        nsh = int((qsh[qp] < NP).sum())
                        held = min(max(int(qlen[qp]) // page - nsh, 0), dem)
                    heapq.heappush(events, (s_done[qi] + 1, 1, dem - held))
                elif out_quar[qi]:
                    s_done[qi] = int(out_at[qi]) // B + 1
                    heapq.heappush(events, (s_done[qi] + 1, 1, dem))
            qp += 1
        admitted = sum(1 for s in s_admit if s is not None)
        if admitted != int(out["head"]):
            raise RuntimeError(
                f"obs: schedule replay diverged from the device fill "
                f"(replayed {admitted} admits, the step consumed "
                f"{int(out['head'])}): tracer spans would lie")
        # steps actually run: one past the last eviction, unless a slot is
        # still in flight
        dsteps = [s for s in s_done if s is not None]
        in_flight = any((qi < C or s_admit[qi] is not None)
                        and s_done[qi] is None for qi in range(C + n))
        actual = (steps_run if in_flight else
                  min(steps_run, (max(dsteps) if dsteps else 0) + 1))
        if boundaries[-1][0] > actual:
            boundaries[-1] = (actual, boundaries[-1][1])
        base = self._steps_total
        self._steps_total += actual
        gen_end = {}  # row -> generated count, for carried-out rows
        if alive:
            for b in range(B):
                if not out["free"][b]:
                    gen_end[int(out["req"][b])] = int(out["gen"][b])
        tracer, shard = self.tracer, self.trace_shard
        rids = list(req_ids)
        host_drops = dict(self._host_drops)

        def emit():
            b_s = np.array([s for s, _ in boundaries], float)
            b_t = np.array([t for _, t in boundaries], float)

            def interp_all(steps):
                return np.interp([0 if s is None else s for s in steps],
                                 b_s, b_t)

            t_adm, t_fst = interp_all(s_admit), interp_all(s_first)
            t_don = interp_all(s_done)
            for qi in range(C + n):
                rid = rids[qi]
                if qi >= C:
                    if s_admit[qi] is None:
                        continue  # still queued: no events this run
                    tracer.admitted(rid, t=float(t_adm[qi]),
                                    step=base + s_admit[qi], shard=shard)
                    if out_drop[qi]:
                        tracer.dropped(rid, "gate-reject",
                                       t=float(t_don[qi]),
                                       step=base + s_done[qi])
                        continue
                hd = host_drops.get(qi)
                if hd is not None:
                    # a host fault eviction: terminal at the drain boundary
                    # that saw it
                    step_h, reason, t_h = hd
                    if (s_first[qi] is not None and s_first[qi] <= step_h
                            and gen_end.get(qi, 1) >= 1):
                        tracer.first_token(rid, t=float(t_fst[qi]),
                                           step=base + s_first[qi])
                    if reason == "deadline":
                        tracer.deadline_dropped(rid, t=t_h,
                                                step=base + step_h,
                                                shard=shard)
                    else:
                        tracer.quarantined(rid, t=t_h, step=base + step_h,
                                           shard=shard)
                    continue
                if seen[qi]:
                    if s_first[qi] is not None:
                        tracer.first_token(rid, t=float(t_fst[qi]),
                                           step=base + s_first[qi])
                    tracer.finished(rid, n_tokens=int(out_len[qi]),
                                    t=float(t_don[qi]),
                                    step=base + s_done[qi])
                elif out_quar[qi]:
                    # quarantined in the step: a first token before it
                    # was recorded when the bad one was not the first
                    if (s_first[qi] is not None
                            and s_first[qi] < s_done[qi]):
                        tracer.first_token(rid, t=float(t_fst[qi]),
                                           step=base + s_first[qi])
                    tracer.quarantined(rid, t=float(t_don[qi]),
                                       step=base + s_done[qi], shard=shard)
                elif out_drop[qi]:
                    if s_done[qi] is not None:
                        tracer.dropped(rid, "gate-reject",
                                       t=float(t_don[qi]),
                                       step=base + s_done[qi])
                elif s_first[qi] is not None and gen_end.get(qi, 0) >= 1:
                    # carried out mid-run, first token produced
                    tracer.first_token(rid, t=float(t_fst[qi]),
                                       step=base + s_first[qi])

        # the replay is cheap; the per-request emission runs at the
        # tracer's next read, off the serve path
        tracer.defer(emit)

    def _plan_in_wave(self, kept, qsh, qdem, qstart, qcow, qwsrc, qwneed,
                      wplans) -> Tuple[List[int], bool]:
        """In-wave prefix sharing (JAX ``run``'s share_prefix block): cold
        entries of this wave with identical full-page prefixes share pages
        from wave 0.  The first entry owning a prefix node writes it
        during prefill; later entries read it once the writer's position
        covers the chain.  Mutates the queue plan arrays; returns the
        host pins on the node pages and whether any reader waits."""
        NP = self.engine.scfg.n_pages
        page = self.engine.scfg.page_size
        n = len(kept)
        cold = [k for k in range(n)
                if qstart[k] == 0 and qcow[k] == NP
                and bool((qsh[k] >= NP).all()) and len(kept[k][1]) >= page]
        counts: Dict[tuple, int] = {}
        keys_of: Dict[int, list] = {}
        for k in cold:
            prompt = kept[k][1]
            # a shared page never covers the final prompt token
            keys = [tuple(prompt[: (d + 1) * page])
                    for d in range(len(prompt))
                    if (d + 1) * page <= len(prompt) - 1]
            keys_of[k] = keys
            for key in keys:
                counts[key] = counts.get(key, 0) + 1
        owner: Dict[tuple, int] = {}
        claims: list = []  # node keys in claim (allocation) order
        plan_sh: Dict[int, Tuple[int, int, int]] = {}
        for k in cold:
            keys = [key for key in keys_of[k] if counts[key] >= 2]
            if not keys:
                continue
            # nodes owned by an earlier entry form a prefix of this chain
            read_k, wsrc = 0, -1
            for key in keys:
                if key not in owner:
                    break
                read_k += 1
                wsrc = owner[key]
            for key in keys[read_k:]:
                owner[key] = k
                claims.append(key)
            plan_sh[k] = (read_k, len(keys), wsrc)
        free_ids = np.where(self.pool.ref == 0)[0]
        pins: List[int] = []
        deps = False
        # conservative capacity check against the original demand
        if plan_sh and len(free_ids) >= (len(claims)
                                         + int(qdem.max(initial=0))):
            node_page: Dict[tuple, int] = {}
            for i, key in enumerate(claims):
                pid = int(free_ids[i])
                node_page[key] = pid
                self.pool.ref[pid] += 1  # released at drain
                pins.append(pid)
            for k, (read_k, nsh_k, wsrc) in plan_sh.items():
                chain = [node_page[key] for key in keys_of[k][:nsh_k]]
                qsh[k, :] = NP
                qsh[k, : len(chain)] = chain
                qdem[k] -= nsh_k
                qstart[k] = read_k * page
                qwsrc[k] = wsrc
                qwneed[k] = read_k * page
                deps = deps or read_k > 0
                wplans[k] = dataclasses.replace(
                    wplans[k], shared=chain, start=int(qstart[k]),
                    own=int(qdem[k]))
        return pins, deps


class ContinuousBatcher:
    """Slot-based continuous batching over a ServeEngine (host-driven: one
    step and one token sync per generated token).

    Over a dense engine every step decodes all ``max_batch`` slots at the
    one global position (a free slot feeds token 0), with the gate fused
    into the step once a request brought features (its labels are
    advisory here, as in the JAX package); a prompt is fed a token a step.
    Over a paged engine each slot has its own position and block table.

    ``tracer``/``metrics`` (``obs``) record each request's lifecycle as it
    happens; ``fault_injector`` (``serve.faults``) corrupts sampled tokens
    (the finite check quarantines exactly that slot) and pins the free
    pages (``PoolExhaust``, paged only) at drain boundaries, which for this
    batcher is every step."""

    def __init__(self, engine: ServeEngine, eos_token: int = 0,
                 max_tokens: int = 32, max_queue: Optional[int] = None,
                 tracer=None, metrics=None, max_retries: int = 0,
                 retry_backoff: int = 1,
                 deadline_s: Optional[float] = None,
                 fault_injector=None,
                 clock: Callable[[], float] = time.perf_counter):
        self.engine = engine
        self.mesh = engine.mesh
        self.eos = eos_token
        self.max_tokens = max_tokens
        self.max_queue = max_queue
        self.tracer = None
        self.metrics = None
        self.trace_shard = 0
        self.max_retries = int(max_retries)
        self.retry_backoff = max(1, int(retry_backoff))
        self.default_deadline_s = deadline_s
        self.injector = fault_injector
        self._clock = clock
        self._now = _decision_clock(self.mesh, clock)
        self._drains = 0
        self._retry_q: collections.deque = collections.deque()
        self._exh_holds: List[list] = []  # [due drain, held page ids]
        self._vocab = engine.cfg.vocab_size
        scfg = engine.scfg
        B = scfg.max_batch
        self.slot_free = np.ones(B, bool)
        self.slot_prompt: list = [[] for _ in range(B)]
        self.slot_ptr = np.zeros(B, np.int64)  # prompt tokens consumed
        self.slot_gen: list = [[] for _ in range(B)]
        self.slot_req: list = [None] * B
        self.slot_feat: Optional[np.ndarray] = None  # [B, F] once known
        self.seeds: dict = {}
        self.slot_seed = np.zeros(B, np.int32)
        self._sampler = None
        if scfg.temperature > 0.0:
            t, k, p = scfg.temperature, scfg.top_k, scfg.top_p
            dev = engine.device
            self._sampler = lambda lg, sd, gi: S.sample_tokens(
                lg, torch.as_tensor(sd, device=dev),
                torch.as_tensor(gi, device=dev), t, k, p)
        self.queue: collections.deque = collections.deque()
        self.done: dict = {}
        self.done_at: dict = {}  # request_id -> perf_counter at completion
        self.dropped: list = []
        self.drop_reasons: dict = {}  # request_id -> why it was dropped
        self.dropped_at: dict = {}  # request_id -> perf_counter at drop
        self.deadline: dict = {}  # request_id -> absolute deadline
        self.max_live = 0  # peak concurrent slots
        self.steps = 0  # steps run (one decode step each)
        self.pool = None  # the page allocator (paged mode)
        if scfg.paged:
            self.slot_pos = np.zeros(B, np.int64)
            self.slot_tbl = np.full((B, scfg.pages_per_slot), scfg.n_pages,
                                    np.int32)
            self.pool = scfg.make_pool()
            self.slot_res: list = [None] * B
        self.attach_obs(tracer, metrics)

    def attach_obs(self, tracer=None, metrics=None) -> None:
        """Attach an ``obs`` Tracer/Metrics pair (None detaches); the
        streams are the same with it on or off."""
        _attach_obs(self, tracer, metrics)

    def submit(self, request_id, prompt_tokens,
               features: Optional[np.ndarray] = None,
               deadline_s: Optional[float] = None,
               seed: Optional[int] = None):
        """Enqueue a request (a token sequence, or a bare int as a length-1
        prompt).  ``features`` go through the admission gate; ``deadline_s``
        bounds queue + serve time; ``seed`` keys its sampling noise."""
        self.seeds[request_id] = (int(seed) if seed is not None
                                  else _default_seed(request_id))
        prompt = _submit_traced(self, request_id, prompt_tokens, True)
        ddl = deadline_s if deadline_s is not None else self.default_deadline_s
        dabs = None
        if ddl is not None:
            if ddl <= 0:
                _drop_request(self, request_id, "deadline")
                return False
            dabs = self._now() + float(ddl)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            if self.max_retries > 0:
                _defer_full(self, request_id, prompt, features, dabs)
                return True
            _drop_request(self, request_id, "queue-full")
            return False
        if features is not None:
            keep = self.engine.admit(features[None])[0]
            if not keep:
                _drop_request(self, request_id, "gate-reject")
                return False
        if dabs is not None:
            self.deadline[request_id] = dabs
        self.queue.append((request_id, prompt, features))
        return True

    def _fill_slots(self):
        scfg = self.engine.scfg
        if scfg.paged:
            self.pool.begin_wave()
        # a deadline decides by the slice's clock; a tracer only stamps
        now = (self._now() if self.deadline else
               self._clock() if self.tracer is not None else 0.0)
        free_idx = list(np.where(self.slot_free)[0])
        fi = 0
        while fi < len(free_idx) and self.queue:
            b = free_idx[fi]
            rid, prompt, feat = self.queue[0]
            dabs = self.deadline.get(rid)
            if dabs is not None and now > dabs:
                # an expired queue head never takes a slot or pages
                self.queue.popleft()
                _drop_request(self, rid, "deadline", now)
                continue
            res = None
            if scfg.paged:
                # reservation-based admission: the request's whole
                # worst-case footprint (minus shared prefix pages) must be
                # free; FIFO blocks when the head does not fit
                res = self.pool.reserve(prompt, self.max_tokens)
                if res is None:
                    break
                self.slot_tbl[b] = scfg.n_pages
                self.slot_tbl[b, : len(res.tbl)] = res.tbl
                if res.cow is not None:
                    # the fresh tail page starts as a copy of the
                    # partially matching cached page; rows past the match
                    # stay stale until overwritten (masked by the causal
                    # term)
                    self.engine.copy_page(*res.cow)
                self.slot_pos[b] = res.start
                self.slot_res[b] = res
            self.queue.popleft()
            self.slot_free[b] = False
            self.slot_req[b] = rid
            self.slot_seed[b] = self.seeds.get(rid, _default_seed(rid))
            if self.tracer is not None:
                self.tracer.admitted(rid, t=now, shard=self.trace_shard)
            self.slot_prompt[b] = prompt
            # shared prefix tokens are already in the pool: skip them
            self.slot_ptr[b] = res.start if res is not None else 0
            self.slot_gen[b] = []
            if feat is not None:
                if self.slot_feat is None:
                    self.slot_feat = np.zeros((len(self.slot_free),
                                               len(feat)), np.int32)
                self.slot_feat[b] = feat
            fi += 1

    def _evict(self, b, now):
        self.done[self.slot_req[b]] = self.slot_gen[b]
        self.done_at[self.slot_req[b]] = now
        self.deadline.pop(self.slot_req[b], None)
        if self.tracer is not None:
            # the done_at stamp: tracer spans and drain times agree
            self.tracer.finished(self.slot_req[b],
                                 n_tokens=len(self.slot_gen[b]), t=now)
            self.tracer.drained(self.slot_req[b], t=now)
        self.slot_free[b] = True
        self.slot_req[b] = None
        if self.engine.scfg.paged:
            # completed full prompt pages register in the prefix trie
            self.pool.release(self.slot_res[b], self.slot_prompt[b])
            self.slot_res[b] = None
            self.slot_tbl[b] = self.engine.scfg.n_pages

    def _evict_drop(self, b, reason: str, now: float):
        """Mid-flight eviction on the drop path (deadline / quarantine):
        frees this slot (and its pages, without registering its prefix)."""
        rid = self.slot_req[b]
        self.slot_free[b] = True
        self.slot_req[b] = None
        if self.engine.scfg.paged:
            self.pool.release(self.slot_res[b], self.slot_prompt[b],
                              register=False)
            self.slot_res[b] = None
            self.slot_tbl[b] = self.engine.scfg.n_pages
        _drop_request(self, rid, reason, now)

    def run(self, max_steps: int = 1000) -> dict:
        """Decode until queue + slots drain; returns {request_id: tokens}."""
        B = self.engine.scfg.max_batch
        paged = self.engine.scfg.paged
        inj = self.injector
        for _ in range(max_steps):
            _service_retries(self)
            self._fill_slots()
            self.max_live = max(self.max_live,
                                int((~self.slot_free).sum()))
            if self.slot_free.all() and not self.queue:
                if self._retry_q:
                    # only backed-off retries left: advance the drain clock
                    self._drains += 1
                    continue
                break
            # feed the next un-consumed prompt token, else the last
            # generated token (one token per step)
            tok = np.zeros(B, np.int32)
            for b in range(B):
                if self.slot_free[b]:
                    continue
                ptr, prompt = self.slot_ptr[b], self.slot_prompt[b]
                tok[b] = (prompt[ptr] if ptr < len(prompt)
                          else self.slot_gen[b][-1])
            n_new = (~self.slot_free).astype(np.int32)
            gi = np.array([len(g) for g in self.slot_gen], np.int32)
            if not paged:
                # every slot at the global position; the gate's labels
                # are advisory here (the device batcher acts on them)
                logits, _ = self.engine.step(tok[:, None], self.slot_feat,
                                             block=False)
                nxt = (torch.argmax(logits, dim=-1) if self._sampler is None
                       else self._sampler(logits, self.slot_seed, gi))
                nxt = nxt.cpu().numpy()
            elif self._sampler is None:
                nxt = self.engine.step_paged(tok[:, None], self.slot_tbl,
                                             self.slot_pos, n_new)
            else:
                # sample on the last-position logits, keyed by (request
                # seed, generated-token index); mid-prompt draws are
                # discarded below like argmaxes
                logits = self.engine.step_paged_logits(
                    tok[:, None], self.slot_tbl, self.slot_pos, n_new)
                nxt = self._sampler(logits, self.slot_seed, gi).cpu().numpy()
            self.steps += 1
            now = self._now() if self.deadline else self._clock()
            if inj is not None:
                # faults apply here, at the host drain boundary (every
                # step for this batcher), never inside the step
                for ev in inj.corruptions(self.trace_shard, self._drains):
                    if ev.slot < B and not self.slot_free[ev.slot]:
                        nxt[ev.slot] = ev.value
                if paged:
                    for ev in inj.exhaustions(self.trace_shard,
                                              self._drains):
                        held = self.pool.hold_free_pages()
                        self._exh_holds.append(
                            [self._drains + ev.hold_drains, held])
            for b in range(B):
                if self.slot_free[b]:
                    continue
                if paged:
                    self.slot_pos[b] += 1
                self.slot_ptr[b] = min(self.slot_ptr[b] + 1,
                                       len(self.slot_prompt[b]))
                if self.slot_ptr[b] < len(self.slot_prompt[b]):
                    continue  # mid-prompt prediction: discard
                tokv = int(nxt[b])
                self.slot_gen[b].append(tokv)
                if not (0 <= tokv < self._vocab):
                    # an out-of-range token (a greedy argmax in the padded
                    # vocab columns, as in the JAX package) quarantines
                    # exactly this slot
                    self._evict_drop(b, "quarantined", now)
                    continue
                if self.tracer is not None and len(self.slot_gen[b]) == 1:
                    self.tracer.first_token(self.slot_req[b], t=now)
                if (len(self.slot_gen[b]) >= self.max_tokens
                        or tokv == self.eos):
                    self._evict(b, now)
            if self.deadline:
                for b in range(B):
                    if self.slot_free[b]:
                        continue
                    dabs = self.deadline.get(self.slot_req[b])
                    if dabs is not None and now > dabs:
                        self._evict_drop(b, "deadline", now)
            self._drains += 1
            if self._exh_holds:
                due = [h for h in self._exh_holds if h[0] <= self._drains]
                if due:
                    self._exh_holds = [h for h in self._exh_holds
                                       if h[0] > self._drains]
                    for _, pages in due:
                        self.pool.release_held(pages)
        return self.done
