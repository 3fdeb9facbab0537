"""Plain PyTorch versions of the kernels (the ``ref.py`` contract).

Same semantics as the JAX package's oracles: ``bucketize_ref``,
``ternary_match_ref``, ``lb_lookup_ref`` and ``bnn_popcount_matmul_ref``
mirror its ``kernels/ref.py``, ``fused_eb_ref`` its jnp composition of
encode, pack and match, ``pack_bits_ref`` its ``ops.pack_bits_jnp``, and
``paged_attention_ref`` its jnp paged-attention oracle
(``nn.attn_backend._attend_jnp``), ``linear_ref`` the serve step's
products (``x @ w``; the head's float32 einsum), ``moe_down_combine_ref``
the MoE block's expert down product and combine (``nn/moe.py``'s two
einsums, each float32 sum in a fixed order).  The CPU tests compare the integer ones
with the JAX package bit for bit and the float one within a stated
tolerance; on the card the CUDA kernels are compared with these.

Packed uint32 key words are carried as int32 bit patterns: ``&``, ``==``
and ``<<`` (which wraps into the sign bit) give the uint32 results, and
torch's ``uint32`` lacks ``<<``, ``~`` and ``max`` on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["bucketize_ref", "ternary_match_ref", "pack_codes_ref",
           "fused_eb_ref", "lb_lookup_ref", "LB_EPILOGUES", "popcount32",
           "bnn_popcount_matmul_ref", "bnn_pack_input_ref", "BNN_EPILOGUES",
           "pack_bits_ref", "paged_attention_ref", "linear_ref",
           "moe_down_combine_ref", "moe_expert_out_ref", "moe_combine_ref",
           "as_i32"]


def as_i32(x: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def bucketize_ref(values: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """codes[b, f] = #{t : thresholds[f, t] <= values[b, f]}.

    ``thresholds`` is [F, T] int32 padded with INT32_MAX; values [B, F].
    """
    return (values[:, :, None] >= thresholds[None, :, :]).sum(-1).to(torch.int32)


def ternary_match_ref(keys: torch.Tensor, values: torch.Tensor,
                      masks: torch.Tensor, prio_action: torch.Tensor,
                      default_action: int) -> torch.Tensor:
    """TCAM lookup.  keys [B, W]; rows (values, masks) [N, W], int32 bits.

    ``prio_action[n] = priority[n] * 256 + action[n]``.  Returns the action
    of the highest-priority matching row, else ``default_action``.
    """
    if values.shape[0] == 0:  # all rows folded into the default action
        return torch.full((keys.shape[0],), int(default_action), dtype=torch.int32,
                          device=keys.device)
    hit = ((keys[:, None, :] & masks[None]) == values[None]).all(-1)
    score = torch.where(hit, prio_action[None, :], -1)  # [B, N]
    best = score.max(dim=1).values
    return torch.where(best >= 0, best % 256, int(default_action)).to(torch.int32)


def pack_codes_ref(codes: torch.Tensor, layout: Sequence[Tuple[int, int, int]],
                   n_words: int) -> torch.Tensor:
    """Pack codes [B, F] into key words [B, n_words] by (word, off, width)."""
    words = [torch.zeros(codes.shape[0], dtype=torch.int32, device=codes.device)
             for _ in range(n_words)]
    for f, (word, off, width) in enumerate(layout):
        field = codes[:, f].to(torch.int32) & as_i32((1 << width) - 1)
        words[word] = words[word] | (field << off)
    return torch.stack(words, dim=1)


def fused_eb_ref(values: torch.Tensor, thresholds: torch.Tensor,
                 rows_v: torch.Tensor, rows_m: torch.Tensor,
                 prio_action: torch.Tensor, layout: torch.Tensor,
                 default_action: int, identity: bool = False) -> torch.Tensor:
    """Encode (or identity codes), pack by ``layout`` [F, 3], then match."""
    codes = values if identity else bucketize_ref(values, thresholds)
    lay = [tuple(r) for r in layout.tolist()]
    keys = pack_codes_ref(codes, lay, rows_v.shape[1])
    return ternary_match_ref(keys, rows_v, rows_m, prio_action, default_action)


LB_EPILOGUES = ("sums", "argmax", "argmin", "ovo_vote", "raw")


def lb_lookup_ref(x: torch.Tensor, luts: torch.Tensor, epilogue: str = "sums",
                  bias: Optional[torch.Tensor] = None,
                  pairs: Optional[torch.Tensor] = None, n_classes: int = 0,
                  scale: float = 1.0) -> torch.Tensor:
    """out[b, k] = sum_f luts[f, x[b, f], k].  x [B, F]; luts [F, V, K].

    ``"sums"``: a code outside ``[0, V)`` adds 0, as in the JAX package's
    Pallas kernel (a one-hot product); its jnp oracle differs there (it
    wraps ``[-V, -1]`` and fills INT32_MIN further out).  The sum runs in
    int64 and is cast back to int32, which wraps as the JAX package's int32
    sum does.

    The predict modes are ``LBModel.make_jax_fn``'s chain, step for step:
    x clamped to ``[0, V-1]``, ``s = sums + bias`` wrapped to int32, then
    ``"argmax"`` / ``"argmin"`` (first index on ties), ``"ovo_vote"``
    (pair m votes ``pairs[m, 0]`` when ``s[m] > 0``, else ``pairs[m, 1]``;
    the first of ``n_classes`` with the most votes), each as int32 [B], or
    ``"raw"``: ``float32(s) / float32(scale)`` [B, K] (a tensor divisor,
    so that CUDA divides too and does not multiply by a reciprocal).
    """
    F, V = luts.shape[0], luts.shape[1]
    f_idx = torch.arange(F, device=x.device)[None, :]
    gathered = luts[f_idx, x.long().clamp(0, V - 1)]  # [B, F, K]
    if epilogue == "sums":
        valid = (x >= 0) & (x < V)
        gathered = torch.where(valid[..., None], gathered, 0)
    s = gathered.sum(dim=1, dtype=torch.int64)
    if bias is not None:
        s = s + bias.to(torch.int64)
    s = s.to(torch.int32)
    if epilogue == "sums":
        return s
    if epilogue == "argmax":
        return s.argmax(dim=1).to(torch.int32)
    if epilogue == "argmin":
        return s.argmin(dim=1).to(torch.int32)
    if epilogue == "ovo_vote":
        winner = torch.where(s > 0, pairs[None, :, 0], pairs[None, :, 1])
        classes = torch.arange(n_classes, device=x.device)
        votes = (winner[:, :, None] == classes).sum(dim=1)
        return votes.argmax(dim=1).to(torch.int32)
    if epilogue == "raw":
        div = torch.full((), scale, dtype=torch.float32, device=x.device)
        return s.to(torch.float32) / div
    raise ValueError(f"epilogue {epilogue!r} not in {LB_EPILOGUES}")


_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 bit patterns), as int64.

    SWAR count in int64 on the zero-extended word, so no shift drags the
    sign bit in and no step overflows; no multiplication.
    """
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


BNN_EPILOGUES = ("counts", "sign", "score")


def bnn_pack_input_ref(x: torch.Tensor, in_bits: int) -> torch.Tensor:
    """int32 features [B, F] -> packed words [B, ceil(F*in_bits/32)]: bit
    ``f*in_bits + j`` is bit j of ``x[b, f]`` (two's complement; higher
    bits dropped), LSB-first, pad bits zero."""
    shifts = torch.arange(in_bits, dtype=torch.int32, device=x.device)
    return pack_bits_ref(((x[..., None] >> shifts) & 1).flatten(-2))


def bnn_popcount_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                            in_bits: int = 0, epilogue: str = "counts",
                            n_in: int = 0) -> torch.Tensor:
    """counts[b, n] = sum_w popcount(~(x[b, w] ^ w[n, w])) over packed words.

    x [B, W], w_packed [N, W] (uint32 bits as int32) -> [B, N] int32.  Pad
    bits count as matches.  The kernel's two fused modes, step for step:

    * ``in_bits > 0``: x is the int32 features [B, F], packed first by
      ``bnn_pack_input_ref``;
    * ``epilogue`` ``"sign"`` or ``"score"``: ``dot = 2*(counts - pad) -
      n_in`` with ``pad = 32*W - n_in`` (the ``ops.bnn_forward`` arithmetic);
      ``"score"`` returns dot [B, N], ``"sign"`` the packed ``dot >= 0``
      words [B, ceil(N/32)].
    """
    h = bnn_pack_input_ref(x, in_bits) if in_bits else x
    xnor = ~(h[:, None, :] ^ w_packed[None, :, :])
    counts = popcount32(xnor).sum(dim=-1).to(torch.int32)
    if epilogue == "counts":
        return counts
    pad_bits = 32 * w_packed.shape[1] - n_in
    dot = 2 * (counts - pad_bits) - n_in
    return dot if epilogue == "score" else pack_bits_ref(dot >= 0)


def pack_bits_ref(bits01: torch.Tensor) -> torch.Tensor:
    """Pack 0/1 [..., N] -> words [..., ceil(N/32)] (uint32 bits as int32).

    LSB-first, as ``core.tables.pack_bits_uint32``.  The shifted bits are
    OR-reduced (halving five times), never summed: a word with bit 31 set
    would overflow an int32 sum.
    """
    n = bits01.shape[-1]
    pad = (-n) % 32
    b = (bits01 != 0).to(torch.int32)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(*b.shape[:-1], -1, 32)
    words = b << torch.arange(32, dtype=torch.int32, device=b.device)
    while words.shape[-1] > 1:
        half = words.shape[-1] // 2
        words = words[..., :half] | words[..., half:]
    return words[..., 0]


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tbl: torch.Tensor,
                        positions: torch.Tensor, window,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        ring: bool = False) -> torch.Tensor:
    """Attend ``q [B, C, H, hd]`` over a paged pool through its block table.

    The jnp oracle's op sequence and roundings: gather the logical
    ``[B, n_ps*page, KV, hd]`` view through the clipped table, dequantize in
    ``q.dtype`` (``k.astype(dt) * scale.astype(dt)``), repeat the KV heads;
    ``q.k`` accumulated in float32 and rounded to ``q.dtype``; divided by
    sqrt(hd) in float32, the position mask added; softmax
    (``exp(s - max) / sum``) in float32, the probabilities rounded to
    ``q.dtype``; ``P.V`` accumulated in float32 and rounded to ``q.dtype``.

    The products run in float32 (bf16 products are exact there), so the
    accumulation does not depend on a library's bf16 reduction settings,
    and sqrt(hd) is a tensor: CUDA divides a tensor by a host scalar as a
    multiplication by its reciprocal, which can differ in the last bit.

    ``ring=True``: the ``S`` logical positions are the dense decode cache's
    ring (the reference's ``decode_attention_block``): for a query at
    ``p``, cell ``i`` holds absolute position ``i + (p // S) * S`` when
    ``i <= p % S``, else ``i + (p // S - 1) * S``, and the causal and window
    mask applies to that position, with ``abs >= 0`` besides.  Below the
    wrap the mask is the one without the ring, value for value.
    """
    from ..nn.attn_backend import NEG_INF, position_mask, repeat_kv

    dt = q.dtype
    B, C, H, hd = q.shape
    N, page = k_pages.shape[0], k_pages.shape[1]
    n_ps = block_tbl.shape[1]
    S = n_ps * page
    gtbl = block_tbl.clamp(0, N - 1).long()

    def view(pages, scale):
        x = pages[gtbl]
        if scale is not None:
            x = x.to(dt) * scale[gtbl].to(dt)
        x = repeat_kv(x.reshape(B, S, *pages.shape[2:]).to(dt), H)
        return x.float()

    kf, vf = view(k_pages, k_scale), view(v_pages, v_scale)
    k_pos = torch.arange(S, device=q.device)
    if ring:
        p = positions.long()[..., None]  # [B, C, 1]
        w = torch.div(p, S, rounding_mode="floor")
        cell = torch.where(k_pos <= p - w * S, k_pos + w * S,
                           k_pos + (w - 1) * S)  # [B, C, S] absolute
        mask = position_mask(p, cell, window, causal=True)[..., 0, :]
        mask = torch.where(cell >= 0, mask, torch.full_like(mask, NEG_INF))
    else:
        mask = position_mask(positions, k_pos[None].expand(B, S), window,
                             causal=True)  # [B, C, S]
    sqrt_hd = torch.full((), np.sqrt(hd), dtype=torch.float32, device=q.device)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kf).to(dt)
    s = s.float() / sqrt_hd + mask[:, None, :, :]
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    probs = (e / torch.sum(e, dim=-1, keepdim=True)).to(dt)
    return torch.einsum("bhqs,bshd->bqhd", probs.float(), vf).to(dt)


def linear_ref(x: torch.Tensor, w: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` in x's type; with ``out_dtype =
    torch.float32`` the float32 product of the float32 copies (the JAX
    head's bf16 x bf16 einsum with ``preferred_element_type=float32``),
    one row at a time: a BLAS may block a product over its rows and give a
    row other bits in another row count (ROADMAP §C.6), so each row is its
    own ``[1, K] @ [K, N]``, the same call whatever M is."""
    if out_dtype == torch.float32:
        x2, wf = x.reshape(-1, x.shape[-1]).float(), w.float()
        y = (torch.cat([r @ wf for r in x2.split(1)]) if len(x2)
             else x2 @ wf)
        return y.reshape(*x.shape[:-1], w.shape[1])
    return x @ w.to(x.dtype)


def moe_down_combine_ref(h: torch.Tensor, w_down: torch.Tensor,
                         combine: torch.Tensor) -> torch.Tensor:
    """The JAX MoE block's ``"bsef,efd->bsed"`` rounded to bf16, then
    ``"bsed,bse->bsd"`` with float32 accumulation, on ``h [M, E, F]``,
    ``w_down [E, F, D]`` and ``combine [M, E]`` bf16 -> ``[M, D]`` bf16.

    XLA leaves the order of each float32 sum open; this version fixes it,
    so that the kernel can be held to it bit for bit: ``y[m, e]`` is
    ``y + h[m, e, f] * w[e, f]`` for f = 0, 1, ..., F-1 from zeros, and
    ``out[m]`` is ``out + y[m, e] * combine[m, e]`` for e = 0, 1, ...,
    E-1.  Each product of two bf16 values is exact in float32, so every
    step rounds once.  Each row's result depends on that row alone."""
    return moe_combine_ref(moe_expert_out_ref(h, w_down), combine)


def moe_expert_out_ref(h: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """``y [M, E, D]`` bf16 of ``moe_down_combine_ref``: each ``y[m, e]``
    the F-ascending float32 sum rounded once."""
    M, E, F = h.shape
    wf = w_down.float()
    y = torch.zeros((M, E, w_down.shape[2]), dtype=torch.float32,
                    device=h.device)
    for f in range(F):  # y + h * w: the product is exact, one rounding
        y.addcmul_(h[:, :, f, None].float(), wf[None, :, f])
    return y.to(torch.bfloat16)


def moe_combine_ref(y: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """``out [M, D]`` bf16 of ``moe_down_combine_ref`` from its ``y``: the
    experts added in ascending order in float32, rounded once."""
    M, E, D = y.shape
    yf, cf = y.float(), combine.float()
    out = torch.zeros((M, D), dtype=torch.float32, device=y.device)
    for e in range(E):
        out.add_(yf[:, e] * cf[:, e, None])
    return out.to(torch.bfloat16)
