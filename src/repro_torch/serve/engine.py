"""Serving engine over the paged KV cache, with a Planter admission gate.

Mirrors the host-driven paged path of ``repro.serve.engine``:

* ``ServeEngine`` holds the model parameters on the device, the lazy
  physical page pool (``paged_kv``), the chunked paged step
  (``step_paged`` greedy, ``step_paged_logits`` for sampling), the
  copy-on-write page copy of prefix sharing (``copy_page``) and the
  admission gate (``admit``: the Planter-mapped classifier through
  ``MappedModel.torch_predict("auto", device)``, the ``fused_eb`` kernel
  for a gate-sized table on the card).
* ``ContinuousBatcher`` is the host-driven slot scheduler: ascending-slot
  fill from a FIFO queue, one token per slot per step (prompt tokens
  first, then the last generated token), EOS / max-token eviction, the
  refcounted ``PagePool`` with reservation-based admission, prefix sharing
  (``share_prefix``), the int8 page pool (``kv_int8``), greedy or sampled
  decoding, deadlines and queue-full retries.  Dropped requests record a
  reason: ``gate-reject``, ``queue-full``, ``empty-prompt``, ``deadline``,
  ``quarantined``.

Not ported yet, and raising ``NotImplementedError`` that names the
ROADMAP item rather than taking another path: the dense ring cache
(``step``, ``generate``, a batcher over an engine without ``page_size``;
queue A item 2), ``DeviceContinuousBatcher`` (item 3), the ``obs`` tracer
and metrics and the fault injector (item 4), speculative decoding (item
5), ``mesh`` / ``tp_params`` sharded serving (item 6).
"""
from __future__ import annotations

import collections
import dataclasses
import time
import zlib
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..arch import model as M
from ..arch import sampling as S
from ..arch.config import ArchConfig
from ..core.pipeline import MappedModel
from ..device import resolve_device
from ..nn import attn_backend as AB
from .pages import PagePool
from .pages import page_demand as _page_demand

NOT_PORTED = {
    "dense": "the dense ring cache (decode_step / generate / step) is not "
             "ported yet: ROADMAP queue A item 2; serve through the paged "
             "cache, ServeConfig(page_size=...)",
    "device": "DeviceContinuousBatcher is not ported yet: ROADMAP queue A "
              "item 3; use ContinuousBatcher (the host batcher)",
    "obs": "the obs tracer and metrics and the fault injector are not "
           "ported yet: ROADMAP queue A item 4",
    "spec": "speculative decoding is not ported yet: ROADMAP queue A item 5",
    "mesh": "sharded serving (mesh / tp_params / the router) is not ported "
            "yet: ROADMAP queue A item 6",
}


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


def _drop_request(b, rid, reason: str, now: Optional[float] = None) -> None:
    """Terminal-drop bookkeeping: reason, wall-clock stamp, deadline
    cleanup."""
    now = b._clock() if now is None else now
    b.dropped.append(rid)
    b.drop_reasons[rid] = reason
    b.dropped_at[rid] = now
    b.deadline.pop(rid, None)


def _defer_full(b, rid, prompt, feat, dabs) -> None:
    """Queue-full with retries enabled: park the request in the backoff
    queue, due ``retry_backoff`` drain boundaries from now."""
    b._retry_q.append([b._drains + b.retry_backoff, 1, rid, prompt,
                       feat, dabs])


def _service_retries(b) -> None:
    """Re-attempt deferred submissions whose backoff expired.  Entry:
    ``[due_drain, attempt, rid, prompt, feat, deadline_abs]``; a still-full
    queue reschedules with exponential backoff until ``max_retries``, then
    drops ``queue-full``; an expired deadline drops ``deadline``."""
    if not b._retry_q:
        return
    now = b._clock()
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
            continue
        if attempt >= b.max_retries:
            _drop_request(b, rid, "queue-full", now)
            continue
        ent[0] = b._drains + b.retry_backoff * (1 << attempt)
        ent[1] = attempt + 1
        rest.append(ent)
    b._retry_q = rest


class ServeEngine:
    """The model, its page pool and the admission gate on one device."""

    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig,
                 gate: Optional[MappedModel] = None,
                 gate_backend: str = "auto", mesh=None,
                 tp_params: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        if mesh is not None or tp_params:
            raise NotImplementedError(NOT_PORTED["mesh"])
        M.check_dense(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.gate = gate
        self.gate_fn = (gate.torch_predict(gate_backend, device=self.device)
                        if gate is not None else None)
        self._paged_kv = None

    # ------------------------------------------------------- not ported
    @property
    def state(self):
        raise NotImplementedError(NOT_PORTED["dense"])

    def step(self, tokens, features=None, block: bool = True):
        raise NotImplementedError(NOT_PORTED["dense"])

    def generate(self, prompts, n_tokens: int, features=None,
                 block: bool = True):
        raise NotImplementedError(NOT_PORTED["dense"])

    # ------------------------------------------------------------ paged
    def _require_paged(self) -> None:
        if not self.scfg.paged:
            raise NotImplementedError(NOT_PORTED["dense"])

    @property
    def paged_kv(self) -> AB.PagedKV:
        """The physical page pool, allocated on first use."""
        self._require_paged()
        if self._paged_kv is None:
            self._paged_kv = M.init_paged_kv(
                self.cfg, self.scfg.n_pages, self.scfg.page_size,
                kv_dtype=self.scfg.kv_dtype, device=self.device)
        return self._paged_kv

    def copy_page(self, src: int, dst: int) -> None:
        """Copy physical page ``src`` over ``dst`` in every layer and pool
        tensor, scales included (the copy-on-write of prefix sharing:
        ``dst`` is a fresh page no other request can see)."""
        for pool in self.paged_kv.pools():
            pool[:, dst] = pool[:, src]

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _paged(self, tokens, block_tbl, pos, n_new, sample_greedy: bool):
        out, self._paged_kv = M.paged_decode_step(
            self.params, self.paged_kv, self._ints(block_tbl),
            self._ints(pos), self._ints(tokens), self._ints(n_new), self.cfg,
            sample_greedy=sample_greedy, attn_impl=self.scfg.attn_impl)
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


class DeviceContinuousBatcher:
    """Not ported yet (ROADMAP queue A item 3)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(NOT_PORTED["device"])


class ContinuousBatcher:
    """Slot-based continuous batching over a paged ServeEngine
    (host-driven: one step and one token sync per generated token).

    ``tracer``, ``metrics`` and ``fault_injector`` are the JAX package's
    hooks for ``obs`` and ``serve.faults``; passing one raises
    ``NotImplementedError`` (ROADMAP queue A item 4)."""

    def __init__(self, engine: ServeEngine, eos_token: int = 0,
                 max_tokens: int = 32, max_queue: Optional[int] = None,
                 tracer=None, metrics=None, max_retries: int = 0,
                 retry_backoff: int = 1,
                 deadline_s: Optional[float] = None,
                 fault_injector=None,
                 clock: Callable[[], float] = time.perf_counter):
        engine._require_paged()
        if fault_injector is not None:
            raise NotImplementedError(NOT_PORTED["obs"])
        self.attach_obs(tracer, metrics)
        self.engine = engine
        self.eos = eos_token
        self.max_tokens = max_tokens
        self.max_queue = max_queue
        self.max_retries = int(max_retries)
        self.retry_backoff = max(1, int(retry_backoff))
        self.default_deadline_s = deadline_s
        self._clock = clock
        self._drains = 0
        self._retry_q: collections.deque = collections.deque()
        self._vocab = engine.cfg.vocab_size
        scfg = engine.scfg
        B = scfg.max_batch
        self.slot_free = np.ones(B, bool)
        self.slot_prompt: list = [[] for _ in range(B)]
        self.slot_ptr = np.zeros(B, np.int64)  # prompt tokens consumed
        self.slot_gen: list = [[] for _ in range(B)]
        self.slot_req: list = [None] * B
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
        self.steps = 0  # paged steps run (one paged_decode_step each)
        self.slot_pos = np.zeros(B, np.int64)
        self.slot_tbl = np.full((B, scfg.pages_per_slot), scfg.n_pages,
                                np.int32)
        self.pool = scfg.make_pool()
        self.slot_res: list = [None] * B

    def attach_obs(self, tracer=None, metrics=None) -> None:
        """Not ported yet: ``None`` for both (no instrumentation) is the
        only accepted call."""
        if tracer is not None or metrics is not None:
            raise NotImplementedError(NOT_PORTED["obs"])

    def submit(self, request_id, prompt_tokens,
               features: Optional[np.ndarray] = None,
               deadline_s: Optional[float] = None,
               seed: Optional[int] = None):
        """Enqueue a request (a token sequence, or a bare int as a length-1
        prompt).  ``features`` go through the admission gate; ``deadline_s``
        bounds queue + serve time; ``seed`` keys its sampling noise."""
        self.seeds[request_id] = (int(seed) if seed is not None
                                  else _default_seed(request_id))
        prompt = validate_prompt_or_drop(
            self.engine.scfg, request_id, prompt_tokens, self.max_tokens,
            self.dropped, self.drop_reasons, dense_ok=True,
            dropped_at=self.dropped_at)
        ddl = deadline_s if deadline_s is not None else self.default_deadline_s
        dabs = None
        if ddl is not None:
            if ddl <= 0:
                _drop_request(self, request_id, "deadline")
                return False
            dabs = self._clock() + float(ddl)
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
        self.pool.begin_wave()
        now = self._clock() if self.deadline else 0.0
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
            # reservation-based admission: the request's whole worst-case
            # footprint (minus shared prefix pages) must be free; FIFO
            # blocks when the head does not fit
            res = self.pool.reserve(prompt, self.max_tokens)
            if res is None:
                break
            self.slot_tbl[b] = scfg.n_pages
            self.slot_tbl[b, : len(res.tbl)] = res.tbl
            if res.cow is not None:
                # the fresh tail page starts as a copy of the partially
                # matching cached page; rows past the match stay stale
                # until overwritten (masked by the causal term)
                self.engine.copy_page(*res.cow)
            self.slot_pos[b] = res.start
            self.slot_res[b] = res
            self.queue.popleft()
            self.slot_free[b] = False
            self.slot_req[b] = rid
            self.slot_seed[b] = self.seeds.get(rid, _default_seed(rid))
            self.slot_prompt[b] = prompt
            # shared prefix tokens are already in the pool: skip them
            self.slot_ptr[b] = res.start
            self.slot_gen[b] = []
            fi += 1

    def _evict(self, b, now):
        self.done[self.slot_req[b]] = self.slot_gen[b]
        self.done_at[self.slot_req[b]] = now
        self.deadline.pop(self.slot_req[b], None)
        self.slot_free[b] = True
        self.slot_req[b] = None
        # completed full prompt pages register in the prefix trie
        self.pool.release(self.slot_res[b], self.slot_prompt[b])
        self.slot_res[b] = None
        self.slot_tbl[b] = self.engine.scfg.n_pages

    def _evict_drop(self, b, reason: str, now: float):
        """Mid-flight eviction on the drop path (deadline / quarantine):
        frees this slot's pages without registering its prefix."""
        rid = self.slot_req[b]
        self.slot_free[b] = True
        self.slot_req[b] = None
        self.pool.release(self.slot_res[b], self.slot_prompt[b],
                          register=False)
        self.slot_res[b] = None
        self.slot_tbl[b] = self.engine.scfg.n_pages
        _drop_request(self, rid, reason, now)

    def run(self, max_steps: int = 1000) -> dict:
        """Decode until queue + slots drain; returns {request_id: tokens}."""
        B = self.engine.scfg.max_batch
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
            if self._sampler is None:
                nxt = self.engine.step_paged(tok[:, None], self.slot_tbl,
                                             self.slot_pos, n_new)
            else:
                # sample on the last-position logits, keyed by (request
                # seed, generated-token index); mid-prompt draws are
                # discarded below like argmaxes
                gi = np.array([len(g) for g in self.slot_gen], np.int32)
                logits = self.engine.step_paged_logits(
                    tok[:, None], self.slot_tbl, self.slot_pos, n_new)
                nxt = self._sampler(logits, self.slot_seed, gi).cpu().numpy()
            self.steps += 1
            now = self._clock()
            for b in range(B):
                if self.slot_free[b]:
                    continue
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
        return self.done
