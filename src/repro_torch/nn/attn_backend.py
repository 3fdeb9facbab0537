"""Attention-backend registry and the ``PagedKV`` page pool.

Mirrors ``repro.nn.attn_backend``:

* **position primitives** — ``position_mask`` (causal + sliding-window
  masking on absolute positions, the one mask truth table of the paged
  path, its plain version and its kernel) and ``repeat_kv``;
* **the backend registry** of this package.  Two backends: ``"torch"``,
  the plain PyTorch version (``kernels.ref.paged_attention_ref``), and
  ``"cuda"``, the hand-written Hopper kernel
  (``kernels.paged_attention``).  ``resolve("auto", device)`` gives the
  kernel for a CUDA tensor and the plain version for a CPU tensor, and
  nothing else.  The JAX package's ``"jnp"`` and ``"pallas"`` names are
  not registered here: they mean other code.

A backend is ``fn(q, kv, *, n_heads, head_dim, window) -> [B, C, H, hd]``
over an already-written :class:`PagedKV` (pools updated, view set); the
page write runs once, outside the backend, in
``nn.attention.paged_decode_attention_block``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

NEG_INF = -2.0**30


def position_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window,
                  causal: bool) -> torch.Tensor:
    """Additive float32 mask ``[..., qb, Sk]`` from absolute positions:
    0 where a query may see a key, ``NEG_INF`` elsewhere.  ``window`` is a
    per-layer scalar (0 = full attention)."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok = ok & (diff >= 0)
    window = int(window)
    if window > 0:
        ok = ok & (diff < window)
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, zero + NEG_INF)


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,S,KV,hd] -> [B,S,H,hd] by group broadcast (head h reads KV head
    h // (H/KV))."""
    B, S, KV, hd = k.shape
    if KV == n_heads:
        return k
    reps = n_heads // KV
    return k[:, :, :, None, :].expand(B, S, KV, reps, hd).reshape(
        B, S, n_heads, hd)


@dataclasses.dataclass
class PagedKV:
    """The paged KV cache: physical pools plus, for one call, the view.

    * **pool-level** (``model.init_paged_kv``): ``k``/``v`` are
      ``[n_layers, N_pages, page, KV, hd]``; an int8 pool adds float32
      ``k_scale``/``v_scale`` planes ``[..., KV, 1]``; view fields None.
    * **per-layer view** (one attention call): the pools without the
      layer axis (views into the stacked pools, so a write lands in
      them), plus ``block_tbl [B, n_ps]``, ``pos [B, C]`` and the scatter
      coordinates ``page_ids``/``page_off [B, C]`` (an id of ``N_pages``
      or more drops the write: padded chunk slots) and ``rows``, the
      write's plan (``nn.attention.write_rows``: a dropped row repeats a
      kept row's write, so the host never waits), found once per step
      rather than once per layer.
    * **the dense ring** (``ring=True``, ``nn.attention.dense_view``): one
      layer of the dense decode cache ``[B, S, KV, hd]`` read as a pool of
      ``B`` pages of ``S`` positions with the identity table, its positions
      a ring of ``S`` cells (``kernels.paged_attention``).
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    block_tbl: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    page_ids: Optional[torch.Tensor] = None
    page_off: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None
    ring: bool = False

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def n_pages(self) -> int:
        return self.k.shape[-4]

    def pools(self) -> Tuple[torch.Tensor, ...]:
        """The pool tensors (k, v and, when quantized, the scale planes)."""
        out = (self.k, self.v)
        return out + (self.k_scale, self.v_scale) if self.quantized else out

    def layer(self, i: int) -> "PagedKV":
        """Layer ``i`` of a stacked pool: views, so writes land in place."""
        return dataclasses.replace(
            self, k=self.k[i], v=self.v[i],
            k_scale=self.k_scale[i] if self.quantized else None,
            v_scale=self.v_scale[i] if self.quantized else None)

    def with_view(self, block_tbl, pos, page_ids, page_off,
                  rows) -> "PagedKV":
        return dataclasses.replace(self, block_tbl=block_tbl, pos=pos,
                                   page_ids=page_ids, page_off=page_off,
                                   rows=rows)

    def pool(self) -> "PagedKV":
        return dataclasses.replace(self, block_tbl=None, pos=None,
                                   page_ids=None, page_off=None, rows=None)


# --------------------------------------------------------------------
# backend registry
# --------------------------------------------------------------------

_BACKENDS: Dict[str, Callable] = {}


def register(name: str, fn: Callable) -> None:
    _BACKENDS[name] = fn


def get(name: str) -> Callable:
    if name not in _BACKENDS:
        raise KeyError(f"unknown attention backend {name!r}; "
                       f"registered: {available()}")
    return _BACKENDS[name]


def available() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def resolve(impl: str, device: Union[str, torch.device, None] = None) -> str:
    """An ``attn_impl`` name -> a registered backend.  ``"auto"`` is the
    kernel on a CUDA device and the plain version on the CPU and on meta
    tensors (shapes only, the dry-run planner's); explicit
    names pass through (``"torch"`` on the card is the plain version there,
    which the parity checks use)."""
    if impl == "auto":
        if device is None:
            raise ValueError("attn_impl 'auto' resolves by device: pass one")
        dev = torch.device(device)
        if dev.type == "cuda":
            return "cuda"
        if dev.type in ("cpu", "meta"):
            return "torch"
        raise ValueError(f"no attention backend for device {dev}")
    if impl not in _BACKENDS:
        raise ValueError(f"attn_impl must be 'auto' or one of "
                         f"{available()}; got {impl!r}")
    return impl


def valid_impls() -> Tuple[str, ...]:
    return ("auto",) + available()


def _attend_torch(q, kv: PagedKV, *, n_heads: int, head_dim: int, window):
    from ..kernels.ref import paged_attention_ref
    return paged_attention_ref(q, kv.k, kv.v, kv.block_tbl, kv.pos, window,
                               k_scale=kv.k_scale, v_scale=kv.v_scale,
                               ring=kv.ring)


def _attend_cuda(q, kv: PagedKV, *, n_heads: int, head_dim: int, window):
    from ..kernels.paged_attention import paged_attention
    if q.device.type != "cuda":
        raise ValueError(f"attention backend 'cuda' got a tensor on "
                         f"{q.device}; use 'torch' or 'auto' there")
    return paged_attention(q, kv.k, kv.v, kv.block_tbl, kv.pos, window,
                           k_scale=kv.k_scale, v_scale=kv.v_scale,
                           ring=kv.ring)


register("torch", _attend_torch)
register("cuda", _attend_cuda)
