"""GQA attention with qk-norm, biases and sliding windows over the paged
KV cache (mirrors the paged half of ``repro.nn.attention``).

The dense ring cache (``decode_attention_block``) and the blocked
training/prefill attention are not ported yet (ROADMAP queue A items 2
and 8: the dense ``decode_step``/``generate``; training).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..kernels import ops
from . import attn_backend as AB
from .attn_backend import PagedKV
from .common import apply_rope, dense_init, rms_norm


def init_attention(gen: Optional[torch.Generator], d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, qkv_bias: bool = False,
                   qk_norm: bool = False,
                   device: Union[str, torch.device] = "cpu") -> Dict:
    p = {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), device=device),
        "wk": dense_init(gen, (d_model, n_kv_heads * head_dim), device=device),
        "wv": dense_init(gen, (d_model, n_kv_heads * head_dim), device=device),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), device=device),
    }
    def zeros(n: int) -> torch.Tensor:
        return torch.zeros((n,), dtype=torch.float32, device=device)

    if qkv_bias:
        p["bq"] = zeros(n_heads * head_dim)
        p["bk"] = zeros(n_kv_heads * head_dim)
        p["bv"] = zeros(n_kv_heads * head_dim)
    if qk_norm:
        p["q_norm"] = zeros(head_dim)
        p["k_norm"] = zeros(head_dim)
    return p


def _project_qkv(p: Dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
                 head_dim: int, rope, qk_norm: bool, norm_eps: float):
    dt = x.dtype
    B, S, _ = x.shape
    q, k, v = ops.linear_group(x, [p["wq"], p["wk"], p["wv"]])
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv_heads, head_dim)
    v = v.reshape(B, S, n_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    if rope is not None:
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)
    return q, k, v


def quantize_kv_int8(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 values, per-vector float32 scale [..., 1]).

    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
    int8 pages equal the JAX package's bit for bit on the same input.
    """
    tf = t.float()
    scale = torch.amax(torch.abs(tf), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(tf / scale), -127, 127)
    return q.to(torch.int8), scale


def drop_plan(idx: torch.Tensor, n: int, at: Optional[torch.Tensor] = None):
    """The plan of a scatter of rows to ``idx [R]`` that drops every index
    outside ``[0, n)`` (the JAX package's ``mode="drop"``), for
    ``put_rows``: ``(at, src, none)``.  Row ``r`` writes row ``src[r]`` to
    ``at[r]``: itself to its own index when that is in range, else the
    first row whose index is, repeating its write (the same target, the
    same value); when no row's index is in range, ``none`` is set and
    every row puts the first entry back as it was.  ``at`` defaults to
    ``idx``; another target (a flat cell) may be given for the same rows.
    Only device ops: no ``nonzero``, so the host never waits and a CUDA
    graph can hold it."""
    keep = (idx >= 0) & (idx < n)
    first = torch.argmax(keep.to(torch.int32))
    src = torch.where(keep, torch.arange(idx.numel(), device=idx.device),
                      first)
    none = ~keep.any()
    at = idx if at is None else at
    return torch.where(none, 0, at[src]).long(), src, none


def put_rows(dst: torch.Tensor, dim: int, plan, val: torch.Tensor) -> None:
    """``dst[..., at[r], ...] = val[..., src[r], ...]`` along ``dim``, in
    place, after ``drop_plan``.  Duplicate targets carry equal values, so
    the result does not depend on the order the writes land in."""
    at, src, none = plan
    v = torch.where(none, dst.narrow(dim, 0, 1), val.index_select(dim, src))
    dst.index_copy_(dim, at, v.to(dst.dtype))


def write_rows(page_ids: torch.Tensor, page_off: torch.Tensor,
               n_pages: int, page: int):
    """The ``drop_plan`` of a chunk's ``[B, C]`` rows into the flat cells
    (``page_id * page + page_off``) of a pool of ``n_pages`` pages: a row
    whose page id lies outside the pool drops (a padded chunk slot).
    Found once per step for every layer's write."""
    cell = (page_ids.reshape(-1).long() * page
            + page_off.reshape(-1).long())
    return drop_plan(page_ids.reshape(-1), n_pages, at=cell)


def _paged_write(kv: PagedKV, k: torch.Tensor, v: torch.Tensor) -> PagedKV:
    """Scatter a chunk's projected K/V into their physical pages, in place.

    The JAX write is ``pool.at[page_ids, page_off].set(..., mode="drop")``:
    an id past the pool (``N_pages``, a padded chunk slot) drops its row.
    ``index_put_`` would raise on such an id, and filtering the rows would
    make the host wait for the device, so the write follows ``kv.rows``
    (``write_rows``, found once per step for all layers): a dropped row
    repeats a kept row's write.  The pools are written in place: ``kv``'s
    tensors are views into the stacked ``[n_layers, ...]`` pool, which the
    serve step owns (the JAX package returns a new pool instead).  The
    int8 pool quantizes per token vector and writes the scale planes
    beside it.
    """
    k = k.reshape(-1, *k.shape[2:])  # [B*C, KV, hd]
    v = v.reshape(-1, *v.shape[2:])
    planes = [(kv.k, k), (kv.v, v)]
    if kv.quantized:
        kq, ks = quantize_kv_int8(k)
        vq, vs = quantize_kv_int8(v)
        planes = [(kv.k, kq), (kv.v, vq), (kv.k_scale, ks), (kv.v_scale, vs)]
    for pool, rows in planes:
        put_rows(pool.view(-1, *pool.shape[2:]), 0, kv.rows, rows)
    return kv


def paged_decode_attention_block(
    p: Dict,
    x: torch.Tensor,  # [B, C, D] chunk of current tokens' activations
    kv: PagedKV,  # one layer's pools with the view attached
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    window,
    qk_norm: bool,
    norm_eps: float,
    rope,
    impl: str = "auto",
) -> Tuple[torch.Tensor, PagedKV]:
    """Chunked decode attention through the paged (block-table) KV cache.

    Projects the chunk, writes its K/V into their pages (in place), then
    every query attends over the logical view through the backend that
    ``impl`` names (``attn_backend.resolve``: ``"auto"`` is the CUDA
    kernel on the card and the plain version on the CPU).  The write runs
    outside the backend, so the pools are the same whichever attends.
    ``rope`` is the step's ``(cos, sin)`` (``nn.common.rope_cos_sin`` of
    ``kv.pos``; None for a model without RoPE), computed once a step for
    every layer.  Returns ``(out [B, C, D], kv)``.
    """
    if not isinstance(kv, PagedKV) or kv.rows is None:
        raise TypeError(f"paged_decode_attention_block expects a PagedKV "
                        f"with its view attached, got {type(kv)}")
    B, C, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rope,
                           qk_norm, norm_eps)
    kv = _paged_write(kv, k, v)
    attend = AB.get(AB.resolve(impl, x.device))
    out = attend(q, kv, n_heads=n_heads, head_dim=head_dim, window=window)
    out = ops.linear(out.reshape(B, C, n_heads * head_dim), p["wo"])
    return out, kv
