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
* ``DeviceContinuousBatcher`` is the serve hot path: the same schedule
  with the slot state on the device and fill -> gate -> decode -> sample
  -> evict as one fused step (``_FusedStep``), ``prefill_chunk`` prompt
  tokens a slot a step, ``sync_every`` steps a host round trip; on the
  card each step shape is a CUDA graph.

Not ported yet, and raising ``NotImplementedError`` that names the
ROADMAP item rather than taking another path: the dense ring cache
(``step``, ``generate``, either batcher over an engine without
``page_size``; queue A item 2), the ``obs`` tracer and metrics and the
fault injector (item 4), speculative decoding (item 5), ``mesh`` /
``tp_params`` sharded serving (item 6).
"""
from __future__ import annotations

import collections
import dataclasses
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
from ..nn import attention as A
from ..nn import attn_backend as AB
from .pages import PagePool
from .pages import page_demand as _page_demand

NOT_PORTED = {
    "dense": "the dense ring cache (decode_step / generate / step) is not "
             "ported yet: ROADMAP queue A item 2; serve through the paged "
             "cache, ServeConfig(page_size=...)",
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


class _FusedStep:
    """One shape key's fused paged serve step over static device buffers.

    The JAX package's ``_make_run_k_paged`` one_step (without the
    speculative branch) on torch tensors: fill with page reservation and
    FIFO blocking, in-wave sharing waits, copy-on-write, the chunk build,
    the in-step gate, the greedy or sampled decode, and eviction with
    refcount release and prefix holds.  Every tensor it reads or writes
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
                 n_feat: int, p_max: int, gated: bool):
        scfg = b.engine.scfg
        dev = b.engine.device
        B, N, n_ps = scfg.max_batch, scfg.n_pages, scfg.pages_per_slot
        self.b, self.Nq, self.R, self.p_max = b, Nq, R, p_max
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
            n_work=i32())
        self.graph = None

    # ------------------------------------------------------------ host
    def write(self, queue: Dict[str, np.ndarray],
              state: Dict[str, np.ndarray]) -> None:
        """Copy host arrays into the leading rows of the buffers (between
        rounds only: a wave's queue and slot state, or a drain's
        evictions)."""
        for bufs, arrays in ((self.q, queue), (self.st, state)):
            for name, a in arrays.items():
                buf = bufs[name]
                a = torch.from_numpy(np.array(a, order="C"))
                (buf[: len(a)] if buf.dim() else buf).copy_(a)

    def reset(self) -> None:
        """Empty the output rings and counters for a new wave."""
        st = self.st
        for name in ("head", "out_len", "out_done", "out_drop", "out_quar",
                     "out_at", "n_work", "wdone"):
            st[name].zero_()
        st["out_tbl"].fill_(self.b.engine.scfg.n_pages)

    def read(self, *names: str) -> Dict[str, np.ndarray]:
        return {n: self.st[n].cpu().numpy() for n in names}

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
        cuBLAS and settles the allocator before capture."""
        st = self.st
        st["free"].fill_(True)
        self.q["n"].zero_()
        side = torch.cuda.Stream(device=st["free"].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.step()
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

        # --- chunk build: up to C prompt tokens, else the last token
        rem = plen - pos
        prefilling = active & (rem > 0)
        c = torch.where(active, torch.where(prefilling, rem.clamp(max=C), 1),
                        0)
        jc = torch.arange(C, device=dev)[None]
        ptoks = torch.gather(pbuf, 1, (pos[:, None] + jc).clamp(0, p_max - 1))
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
        # --- decode
        if scfg.temperature == 0.0:
            nxt, _ = M.paged_decode_step(
                eng.params, b._pages, tbl, pos, chunk, c, eng.cfg,
                sample_greedy=True, attn_impl=scfg.attn_impl)
        else:
            logits, _ = M.paged_decode_step(
                eng.params, b._pages, tbl, pos, chunk, c, eng.cfg,
                attn_impl=scfg.attn_impl)
            nxt = S.sample_tokens(logits, seed, gen, scfg.temperature,
                                  scfg.top_k, scfg.top_p)
        pos = pos + c
        live = active & (pos >= plen) & ~gdrop  # prompt consumed
        st["out_tok"].index_put_(
            (torch.where(live, req, R).long(),
             gen.clamp(max=b.max_tokens - 1).long()), nxt)
        gen = gen + live.to(torch.int32)
        bad = live & ((nxt < 0) | (nxt >= b._vocab))
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

    Not ported yet, raising ``NotImplementedError`` naming the ROADMAP
    queue A item: an engine without ``page_size`` (the dense mode, item
    2), ``tracer``/``metrics``/``fault_injector`` (item 4),
    ``spec_k``/``draft`` (item 5) and ``mesh`` (item 6).
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
        if mesh is not None:
            raise NotImplementedError(NOT_PORTED["mesh"])
        if spec_k or draft is not None:
            raise NotImplementedError(NOT_PORTED["spec"])
        if fault_injector is not None:
            raise NotImplementedError(NOT_PORTED["obs"])
        engine._require_paged()
        self.attach_obs(tracer, metrics)
        self.engine = engine
        self.eos = int(eos_token)
        self.max_tokens = int(max_tokens)
        self.sync_every = max(1, int(sync_every))
        self.pregate = pregate
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.max_queue = max_queue
        self.max_retries = int(max_retries)
        self.retry_backoff = max(1, int(retry_backoff))
        self.default_deadline_s = deadline_s
        self._clock = clock
        self._drains = 0
        self._retry_q: collections.deque = collections.deque()
        self._vocab = engine.cfg.vocab_size
        self.graph = bool(graph) and engine.device.type == "cuda"
        scfg = engine.scfg
        self._B = scfg.max_batch
        # the batcher's own page pool (fixed addresses: a captured step
        # writes it in place) and its host mirror with the prefix trie
        self._pages = M.init_paged_kv(engine.cfg, scfg.n_pages,
                                      scfg.page_size, kv_dtype=scfg.kv_dtype,
                                      device=engine.device)
        self.pool = scfg.make_pool()
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

    @property
    def steps_wasted(self) -> int:
        """Identity steps run after a round's work ran out."""
        return self.steps_executed - self.steps

    def attach_obs(self, tracer=None, metrics=None) -> None:
        """Not ported yet: ``None`` for both is the only accepted call."""
        if tracer is not None or metrics is not None:
            raise NotImplementedError(NOT_PORTED["obs"])

    def submit(self, request_id, prompt_tokens,
               features: Optional[np.ndarray] = None,
               deadline_s: Optional[float] = None,
               seed: Optional[int] = None):
        """Enqueue; admission happens batched in ``run()``.  ``deadline_s``
        bounds queue + serve time; ``seed`` keys the sampling noise."""
        self.seeds[request_id] = (int(seed) if seed is not None
                                  else _default_seed(request_id))
        prompt = validate_prompt_or_drop(
            self.engine.scfg, request_id, prompt_tokens, self.max_tokens,
            self.dropped, self.drop_reasons, dropped_at=self.dropped_at)
        ddl = deadline_s if deadline_s is not None else self.default_deadline_s
        dabs = None
        if ddl is not None:
            if ddl <= 0:
                _drop_request(self, request_id, "deadline")
                return False
            dabs = self._clock() + float(ddl)
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

    @property
    def _pfree(self) -> np.ndarray:
        """Free-page view over the refcounted pool mirror."""
        return self.pool.ref == 0

    def _fused(self, key: Tuple) -> _FusedStep:
        fs = self._steps.get(key)
        if fs is None:
            fs = self._steps[key] = _FusedStep(self, *key)
            if self.graph:
                fs.capture()
        return fs

    def _evict_deadlines(self, fs: _FusedStep, req_ids: list,
                         now: float) -> None:
        """Deadline eviction at one drain boundary (the deadline part of
        the JAX batcher's ``_apply_drain_faults``): an expired live slot
        frees its pages without registering its prefix."""
        NP = self.engine.scfg.n_pages
        host = fs.read("free", "req")
        free, req = host["free"].copy(), host["req"]
        evict = [b for b in range(self._B)
                 if not free[b] and int(req[b]) < len(req_ids)
                 and now > self.deadline.get(req_ids[int(req[b])],
                                             float("inf"))]
        if not evict:
            return
        host = fs.read("tbl", "pref")
        tbl, pref = host["tbl"].copy(), host["pref"].copy()
        for b in evict:
            free[b] = True
            np.subtract.at(pref, tbl[b][tbl[b] < NP], 1)
            tbl[b] = NP
            _drop_request(self, req_ids[int(req[b])], "deadline", now)
        fs.write({}, dict(free=free, tbl=tbl, pref=pref))

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
        # batched admission: one gate launch over the whole waiting queue
        keep = np.ones(len(pending), bool)
        gated = [i for i, (_, _, f) in enumerate(pending) if f is not None]
        if gated and eng.gate_fn is not None and self.pregate:
            keep[gated] = eng.admit(np.stack([pending[i][2] for i in gated]))
        req_ids: List = [c["rid"] for _, c in carry]
        kept: List[Tuple] = []
        now0 = self._clock() if self.deadline else 0.0
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
        longest = max([len(p) for _, p, _ in kept]
                      + [len(c["prompt"]) for _, c in carry] + [1])
        p_max = max(4, 1 << (longest - 1).bit_length())
        NP, n_ps = scfg.n_pages, scfg.pages_per_slot
        qtok = np.zeros((Nq, p_max), np.int32)
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
        self.pool.begin_wave()
        # qi -> (prompt, register-on-completion) for drain registration
        winfo: List[Tuple[list, bool]] = [
            (c["prompt"], c.get("reg", False)) for _, c in carry]
        wplans: List = []  # kept index -> PagePlan (stats at drain)
        for k, (rid, prompt, f) in enumerate(kept):
            qseed[k] = self.seeds.get(rid, _default_seed(rid))
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
            qreq[k] = C + k  # output row: carryover rows come first
            if f is not None:
                qfeat[k, : len(f)] = f[:n_feat]
                qhasf[k] = True
        wave_pins: List[int] = []  # host pins on in-wave shared pages
        wave_deps = False  # any reader waiting on an in-wave writer?
        if scfg.share_prefix:
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
            pos[b] = c["pos"]
            plen[b] = len(c["prompt"])
            pbuf[b, : len(c["prompt"])] = c["prompt"]
            tbl[b] = c["tbl"]
            reg[b] = c.get("reg", False)
        fs = self._fused((Nq, R, n_feat, p_max, bool(feats)))
        fs.reset()
        fs.write(
            dict(tok=qtok, len=qlen, req=qreq, feat=qfeat, hasf=qhasf,
                 sh=qsh, dem=qdem, start=qstart, cow=qcow, reg=qreg,
                 seed=qseed, wsrc=qwsrc, wneed=qwneed,
                 n=np.asarray(n, np.int32)),
            dict(free=free, req=req, gen=gen, last=last, feat=feat,
                 hasf=hasf, seed=seed, out_tok=out_tok, pos=pos, plen=plen,
                 pbuf=pbuf, tbl=tbl, reg=reg, pref=self.pool.ref,
                 qidx=np.full(B, -1, np.int32)))

        seen = np.zeros(R, bool)
        remaining = max_steps
        alive = True
        while remaining > 0:
            k = min(self.sync_every, remaining)
            fs.run(k)
            self.steps_executed += k
            # the round's one read: the done mask and the flags
            flags = torch.cat([fs.st["out_done"][:R], fs.st["alive"].view(1),
                               fs.st["more"].view(1)]).cpu().numpy()
            done_mask, alive, more = flags[:R], bool(flags[R]), flags[R + 1]
            now = self._clock()
            remaining -= k
            for qi in np.where(done_mask & ~seen)[0]:
                self.done_at[req_ids[qi]] = now
                self.deadline.pop(req_ids[qi], None)
            seen = done_mask
            self._drains += 1
            if self.deadline:
                self._evict_deadlines(fs, req_ids, now)
            if not alive:
                break
            if not more and remaining > 0:
                # the next round could only find no work: count its
                # drain boundary as the JAX loop does, without running it
                self._clock()
                self._drains += 1
                alive = False
                break
        out = fs.read("pref", "head", "out_tok", "out_len", "out_drop",
                      "out_quar", "out_at", "out_tbl", "n_work", "free",
                      "req", "gen", "last", "feat", "hasf", "seed", "pos",
                      "plen", "pbuf", "tbl", "reg")
        self.steps += int(out["n_work"])
        self.pool.ref[:] = out["pref"][:NP]
        if wave_pins:
            # drop the host pins on in-wave shared node pages
            np.subtract.at(self.pool.ref, np.asarray(wave_pins), 1)
        self.pool.observe_occupancy()
        # sharing stats: exactly the entries the step admitted this run
        head = int(out["head"])
        for k in range(min(head, n)):
            self.pool.record_plan(wplans[k], len(kept[k][1]))
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
        # in-step drops in the order the step made them: (step, slot)
        for qi in sorted(drops, key=lambda qi: out["out_at"][qi]):
            _drop_request(self, req_ids[qi], "quarantined"
                          if out["out_quar"][qi] else "gate-reject")
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
                    toks=out["out_tok"][qi, :g].copy(),
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
        # pressure-release cached prefixes (LRU leaf-first) so the wave's
        # largest own demand can be met; pages the wave shares are pinned
        keep_pin = set(int(p) for p in qsh[qsh < NP])
        keep_pin |= set(int(p) for p in qcow[qcow < NP])
        self.pool.ensure_free(int(qdem.max(initial=0)), keep_pin)
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
