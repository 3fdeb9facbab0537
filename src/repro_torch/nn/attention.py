"""GQA attention with qk-norm, biases and sliding windows over the paged
KV cache and the dense ring cache (mirrors the decode half of
``repro.nn.attention``).

Both caches attend through the same backend (``attn_backend``): the dense
cache's layer ``[B, S, KV, hd]`` is read as a pool of ``B`` pages of ``S``
positions with the identity table and the ring flag (``dense_view``), so
on the card the dense step runs the same ``paged_attention`` kernel at the
same ``S`` as the paged step, and the two give the same bits.

Training runs ``attention_block`` over ``attend_blocked``, the JAX
package's blocked attention in plain torch (JAX runs no Pallas kernel
there either), with its roundings: the q.k product in bf16, scaled in
float32, masked and softmaxed in float32, P.V in bf16.  The enc-dec
family adds ``cross_kv``, ``attention_block``'s ``kv_override`` (the
decoder's cross-attention over the encoder) and ``cross_decode_attention``
(its decode step over the ``cross`` planes, plain torch as in the JAX
package).

Over ranks (a cache whose ``split`` is set, ``dist.sharding.SeqSplit``)
each rank holds a contiguous part of every page's positions (of the
ring's cells): the write keeps the rows this rank owns, and before the
attention ``gathered`` puts the parts back together in rank order
(``dist.comm.gather``), so the unchanged backend reads the bits the
mesh-less step reads.

Under tensor parallelism (``tp``, a ``dist.sharding.TensorParallel``
whose layout splits the heads) each rank projects its own query and KV
heads (column slices, planned as the whole weights, so bitwise those
columns of the mesh-less launch), writes and reads a cache of its KV
heads over the whole sequence, attends over its heads, and ``wo``'s row
slice gives a float32 partial that ``tp.join`` adds over the ranks in
rank order and rounds once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from . import attn_backend as AB
from .attn_backend import PagedKV
from .common import apply_rope, dense_init, rms_norm, rope_cos_sin

DEFAULT_Q_BLOCK = 512


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
                 head_dim: int, rope, qk_norm: bool, norm_eps: float,
                 tp=None):
    """q, k, v of ``x``: ``n_heads`` / ``n_kv_heads`` are the weights'
    heads (a rank's, with ``tp``, whose whole heads plan the launch)."""
    dt = x.dtype
    B, S, _ = x.shape
    ws = [p["wq"], p["wk"], p["wv"]]
    if tp is None:
        q, k, v = ops.linear_group(x, ws)
    else:
        lay = tp.layout
        q, k, v = ops.linear_group(x, ws, plan_n=(
            lay.n_q * head_dim, lay.n_kv * head_dim, lay.n_kv * head_dim))
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


def attend_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor, window,
                   *, causal: bool = True,
                   q_block: int = DEFAULT_Q_BLOCK) -> torch.Tensor:
    """Blocked softmax attention.  q [B,Sq,H,hd], k/v [B,Sk,H,hd] ->
    [B, Sq, H*hd].

    Query blocks of ``q_block`` rows (the last one padded), so the
    [B,H,qb,Sk] score tile is the peak intermediate.  Roundings as the JAX
    package's: the bf16 q.k einsum times ``1/sqrt(hd)``, which JAX
    promotes to float32 (the scale is a numpy float64); the float32 mask
    (``attn_backend.position_mask``) and softmax; the probabilities cast
    to v's type and P.V in that type.
    """
    B, Sq, H, hd = q.shape
    qb = min(q_block, Sq)
    pad = (-Sq) % qb
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad))
    nblk = (Sq + pad) // qb
    kT = k.permute(0, 2, 3, 1)  # [B,H,hd,Sk]
    vT = v.permute(0, 2, 1, 3)  # [B,H,Sk,hd]
    scale = np.float32(1.0 / np.sqrt(hd))
    outs = []
    for i in range(nblk):
        qi = q[:, i * qb:(i + 1) * qb]  # [B,qb,H,hd]
        pi = q_pos[:, i * qb:(i + 1) * qb]
        s = torch.einsum("bqhd,bhds->bhqs", qi, kT).float() * scale
        m = AB.position_mask(pi, k_pos, window, causal)  # [B,qb,Sk]
        s = s + m[:, None, :, :]
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqs,bhsd->bqhd", p, vT))
    out = torch.cat(outs, dim=1) if nblk > 1 else outs[0]
    # a padded block leaves a strided slice: the products take rows at one
    # stride (ROADMAP C.16)
    return out[:, :Sq].reshape(B, Sq, H * hd).contiguous()


def _project_q(p: Dict, x: torch.Tensor, n_heads: int, head_dim: int,
               rope, qk_norm: bool, norm_eps: float) -> torch.Tensor:
    """The query alone, as ``_project_qkv`` makes it: ``ops.linear`` of
    ``wq`` gives the bits of the group launch's first output."""
    B, S, _ = x.shape
    q = ops.linear(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, S, n_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, p["q_norm"], norm_eps)
    if rope is not None:
        q = apply_rope(q, rope)
    return q


def attention_block(p: Dict, x: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, head_dim: int, rope_theta: float,
                    window, qk_norm: bool, norm_eps: float,
                    positions: Optional[torch.Tensor] = None,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    causal: bool = True, q_block: int = DEFAULT_Q_BLOCK,
                    rope=None) -> torch.Tensor:
    """Self-attention over the whole sequence (training, prefill and the
    encoder; ``causal=False`` sees every position): q/k/v in one
    ``ops.linear_group`` launch, ``attend_blocked``, ``wo`` through
    ``ops.linear``.  ``rope`` may pass ``rope_cos_sin`` of ``positions``
    computed once for every layer.

    With ``kv_override = (k, v)`` (``[B, Sk, KV, hd]``, ``cross_kv``) it is
    cross-attention: the query alone is projected (the JAX package also
    projects k and v from ``x`` and drops them) and attends to every
    override position, without a mask; ``rope_theta=0.0`` means no RoPE."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if rope is None and rope_theta > 0:
        rope = rope_cos_sin(positions, head_dim, rope_theta)
    if kv_override is not None:
        q = _project_q(p, x, n_heads, head_dim, rope, qk_norm, norm_eps)
        ko, vo = kv_override
        Sk = ko.shape[1]
        k_pos = torch.arange(Sk, device=x.device)[None].expand(B, Sk)
        out = attend_blocked(q, AB.repeat_kv(ko, n_heads),
                             AB.repeat_kv(vo, n_heads), positions, k_pos, 0,
                             causal=False, q_block=q_block)
        return ops.linear(out, p["wo"])
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rope,
                           qk_norm, norm_eps)
    out = attend_blocked(q, AB.repeat_kv(k, n_heads),
                         AB.repeat_kv(v, n_heads), positions, positions,
                         window, causal=causal, q_block=q_block)
    return ops.linear(out, p["wo"])


def cross_kv(p: Dict, enc_out: torch.Tensor, n_kv_heads: int,
             head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's K/V for a decoder layer's cross-attention, ``[B, S,
    KV, hd]`` each: ``enc_out @ wk`` and ``enc_out @ wv`` in one
    ``ops.linear_group`` launch (each output the bits of its own
    ``ops.linear``)."""
    B, S, _ = enc_out.shape
    k, v = ops.linear_group(enc_out, [p["wk"], p["wv"]])
    return (k.reshape(B, S, n_kv_heads, head_dim),
            v.reshape(B, S, n_kv_heads, head_dim))


def cross_decode_attention(p: Dict, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, n_heads: int,
                           head_dim: int) -> torch.Tensor:
    """One decode step's cross-attention over a layer's ``cross`` planes
    ``[B, S, KV, hd]``: the JAX package's ``decode_step`` einsums in plain
    torch (no Pallas kernel there either) with its roundings: the bf16
    q.k scores divided by ``sqrt(hd)`` in float32, the float32 softmax cast
    to bf16, P.V in bf16.  No bias, qk-norm, RoPE or mask, as there;
    ``wq`` and ``wo`` through ``ops.linear``.  ``x [B, 1, D]`` is the
    normed hidden state; returns ``[B, 1, D]``."""
    B = x.shape[0]
    dt = x.dtype
    q = ops.linear(x, p["wq"]).reshape(B, 1, n_heads, head_dim)
    kf = AB.repeat_kv(k.to(dt), n_heads)
    vf = AB.repeat_kv(v.to(dt), n_heads)
    s = torch.einsum("bqhd,bshd->bhqs", q, kf).float() / np.float32(
        np.sqrt(head_dim))
    probs = torch.softmax(s, dim=-1).to(dt)
    o = torch.einsum("bhqs,bshd->bqhd", probs, vf).reshape(
        B, 1, n_heads * head_dim)
    return ops.linear(o, p["wo"])


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
               n_pages: int, page: int, split=None):
    """The ``drop_plan`` of a chunk's ``[B, C]`` rows into the flat cells
    (``page_id * page + page_off``) of a pool of ``n_pages`` pages: a row
    whose page id lies outside the pool drops (a padded chunk slot).
    With ``split`` the pool holds this rank's ``page / parts`` offsets of
    every page, and a row at another rank's offset drops too.  Found once
    per step for every layer's write."""
    if split is not None:
        part = page // split.parts
        own = torch.div(page_off, part, rounding_mode="floor") == split.index
        page_ids = torch.where(own, page_ids, n_pages)
        page_off = page_off - split.index * part
        page = part
    cell = (page_ids.reshape(-1).long() * page
            + page_off.reshape(-1).long())
    return drop_plan(page_ids.reshape(-1), n_pages, at=cell)


def gathered(kv: PagedKV) -> PagedKV:
    """One layer's cache whole, as the mesh-less step holds it: every
    rank's part of the positions gathered along dim 1 in rank order
    (``dist.comm.gather``, one a plane); ``kv`` itself when it is not
    split."""
    sp = kv.split
    if sp is None:
        return kv
    from ..dist import comm

    def whole(t):
        return None if t is None else comm.gather(t, 1, sp.group)

    return dataclasses.replace(kv, k=whole(kv.k), v=whole(kv.v),
                               k_scale=whole(kv.k_scale),
                               v_scale=whole(kv.v_scale), split=None)


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


def _tp_heads(tp, n_heads: int, n_kv_heads: int):
    """``(tp, n_heads, n_kv_heads)`` of a step's attention: a rank's heads
    where ``tp``'s layout splits them, else the block whole (``tp``
    None)."""
    if tp is None or not tp.layout.attn:
        return None, n_heads, n_kv_heads
    return tp, tp.layout.q_heads, tp.layout.kv_heads


def _out_proj(p: Dict, out: torch.Tensor, tp) -> torch.Tensor:
    """``out @ wo``; a rank's row slice gives a float32 partial, joined
    over the ranks and rounded once."""
    if tp is None:
        return ops.linear(out, p["wo"])
    return tp.join(ops.linear(out, p["wo"], out_dtype=torch.float32),
                   out.dtype)


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
    tp=None,
) -> Tuple[torch.Tensor, PagedKV]:
    """Chunked decode attention through the paged (block-table) KV cache.

    Projects the chunk, writes its K/V into their pages (in place), then
    every query attends over the logical view through the backend that
    ``impl`` names (``attn_backend.resolve``: ``"auto"`` is the CUDA
    kernel on the card and the plain version on the CPU).  The write runs
    outside the backend, so the pools are the same whichever attends.
    ``rope`` is the step's ``(cos, sin)`` (``nn.common.rope_cos_sin`` of
    ``kv.pos``; None for a model without RoPE), computed once a step for
    every layer.  ``tp`` runs this rank's heads (the module docstring).
    Returns ``(out [B, C, D], kv)``.
    """
    if not isinstance(kv, PagedKV) or kv.rows is None:
        raise TypeError(f"paged_decode_attention_block expects a PagedKV "
                        f"with its view attached, got {type(kv)}")
    B, C, _ = x.shape
    tp, n_heads, n_kv_heads = _tp_heads(tp, n_heads, n_kv_heads)
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rope,
                           qk_norm, norm_eps, tp)
    kv = _paged_write(kv, k, v)
    attend = AB.get(AB.resolve(impl, x.device))
    out = attend(q, gathered(kv), n_heads=n_heads, head_dim=head_dim,
                 window=window)
    out = _out_proj(p, out.reshape(B, C, n_heads * head_dim), tp)
    return out, kv


# ------------------------------------------------------------ dense ring
GQA_IMPLS = ("repeat", "grouped")


def dense_view(k: torch.Tensor, v: torch.Tensor,
               k_scale: Optional[torch.Tensor],
               v_scale: Optional[torch.Tensor], block_tbl: torch.Tensor,
               positions: torch.Tensor, split=None) -> PagedKV:
    """One layer of the dense cache (``[B, S, KV, hd]`` views into the
    stacked ``[n_layers, ...]`` cache, int8 with float32 scale planes
    ``[B, S, KV, 1]``) as the paged backends' pool: ``B`` pages of ``S``
    positions, ``block_tbl [B, 1]`` the identity table, ``positions [B, 1]``
    the step's position, the ring flag set; ``split`` this rank's part of
    the cells over ranks."""
    return PagedKV(k=k, v=v, k_scale=k_scale, v_scale=v_scale,
                   block_tbl=block_tbl, pos=positions, ring=True,
                   split=split)


def _ring_write(kv: PagedKV, k: torch.Tensor, v: torch.Tensor,
                slot: torch.Tensor, commit: Optional[torch.Tensor]) -> None:
    """Write every slot's token K/V ``[B, 1, KV, hd]`` into cell ``slot``
    (``[1]``, ``pos % S``) of the ring, in place: the JAX package's
    ``dynamic_update_slice`` at ``(0, pos % S_max, 0, 0)``; the int8 cache
    quantizes per token vector and writes the scales beside it.  With
    ``commit`` (a 0-dim bool on the device) False the cell is written back
    as it was, so a step that has no work leaves the cache unchanged
    without the host looking at the flag.  With ``kv.split`` the ring holds
    this rank's ``S / parts`` cells, and only the rank owning the cell
    writes it."""
    sp = kv.split
    if sp is not None:
        n = kv.k.shape[1]
        local = slot - sp.index * n
        own = ((local >= 0) & (local < n)).reshape(())
        slot = local.clamp(0, n - 1)
        commit = own if commit is None else commit & own
    planes = [(kv.k, k), (kv.v, v)]
    if kv.quantized:
        kq, ks = quantize_kv_int8(k)
        vq, vs = quantize_kv_int8(v)
        planes = [(kv.k, kq), (kv.v, vq), (kv.k_scale, ks), (kv.v_scale, vs)]
    for cache, new in planes:
        new = new.to(cache.dtype)
        if commit is not None:
            new = torch.where(commit, new, cache.index_select(1, slot))
        cache.index_copy_(1, slot, new)


def decode_attention_block(
    p: Dict,
    x: torch.Tensor,  # [B, 1, D] current token
    kv: PagedKV,  # one layer of the dense cache, ``dense_view``
    slot: torch.Tensor,  # [1] int64, the step's cell pos % S
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    window,
    qk_norm: bool,
    norm_eps: float,
    rope,
    gqa_impl: str = "repeat",
    impl: str = "auto",
    commit: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, PagedKV]:
    """One decode step through the dense ring cache: insert K/V at
    ``pos % S`` (in place; ``commit`` False drops the insert), then attend
    over the valid cells through the backend that ``impl`` names, the
    ring's absolute positions masked (causal, window, ``abs >= 0``).

    ``gqa_impl`` is the JAX package's choice of score einsum, ``"repeat"``
    (K/V broadcast to every query head) or ``"grouped"``; both compute the
    same function, and here both reach the same backend, which reads each
    K/V row once for all the heads of its group.  ``tp`` runs this rank's
    heads (the module docstring).  Returns ``(out [B, 1, D], kv)``.
    """
    if gqa_impl not in GQA_IMPLS:
        raise ValueError(f"gqa_impl must be one of {GQA_IMPLS}, got "
                         f"{gqa_impl!r}")
    if not isinstance(kv, PagedKV) or not kv.ring:
        raise TypeError(f"decode_attention_block expects the dense_view of "
                        f"a layer, got {type(kv)}")
    B = x.shape[0]
    tp, n_heads, n_kv_heads = _tp_heads(tp, n_heads, n_kv_heads)
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rope,
                           qk_norm, norm_eps, tp)
    _ring_write(kv, k, v, slot, commit)
    attend = AB.get(AB.resolve(impl, x.device))
    out = attend(q, gathered(kv), n_heads=n_heads, head_dim=head_dim,
                 window=window)
    out = _out_proj(p, out.reshape(B, 1, n_heads * head_dim), tp)
    return out, kv
