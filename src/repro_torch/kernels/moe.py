"""CUDA kernel: the MoE block's expert down product and combine, one launch.

``out[m] = bf16(sum_e bf16(h[m, e] @ W_down[e]) * combine[m, e])``, JAX's
``"bsef,efd->bsed"`` rounded to bf16, then ``"bsed,bse->bsd"`` with float32
accumulation (``src/repro/nn/moe.py:73-75``), each sum in the order the
plain version (``ref.moe_down_combine_ref``) fixes: F ascending, then the
experts ascending.

Replaces no Pallas kernel: the JAX package leaves both einsums to XLA.  The
port runs its own because its invariants (chunked prefill equal to
token-by-token) need each row's bits to depend on that row alone, which
cuBLAS does not promise.

Bound on the H100 by bytes: a step's rows pick nearly every expert, so the
launch reads nearly all of ``W_down`` (348-369 MB a qwen2-moe layer), and
the routed work takes less time on the float32 lanes.  Design
(``csrc/moe.cu``): a persistent grid (3 blocks an SM) takes work items
from a counter on the card, costliest first (``item_cost``).  A down item
is (expert, up to ``MAX_ROWS`` of its rows, a column tile ``item_width``
wide): a producer warp streams the tile's ``W_down`` slice once with TMA
through a ring of ``STAGES`` stages of ``FC`` F rows, and 4 consumer warps
keep every row's accumulators in registers (a thread 2 columns x R rows,
R in ``R_BUCKETS``), each element's F chain one fmaf chain in one thread,
so the plain version is matched bit for bit on the CUDA cores.  Then
combine items of ``COMBINE_ROWS`` rows x 128 columns add each row's
experts in ascending order over the whole card.  With ``out_dtype=torch.float32``
the combine writes its float32 sums unrounded (a rank's partial over its
experts under tensor parallelism; the cross-rank sum rounds once).  The
list is built on the
card from ``combine`` alone; ``plan`` reckons the same list on the host,
for tests and reports.  An expert whose combine weight is 0 adds nothing,
which is the plain version's bits for every finite product (ROADMAP
C.10).

With a gradient (training) the forward is the same launch and the
backward is ``moe_down_combine_backward``: the JAX VJP of the two einsums
as ``torch.bmm`` over the experts, from the launch's scratch ``ys``.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from ._launch import stream_ptr
from .ref import moe_combine_ref, moe_expert_out_ref

__all__ = ["moe_down_combine", "moe_down_combine_backward",
           "moe_down_combine_bytes", "plan", "item_width"]

launches = 0  # kernel launches; the main-path check reads and resets it

# the constants of csrc/moe.cu (tests/test_torch_moe_kernel.py holds them
# equal)
TD = 128  # columns of a combine tile and of the widest item (kTD)
FC = 32  # F rows a stage (kFC)
STAGES = 4  # the W ring's stages (kStages)
MAX_ROWS = 128  # rows of a down item (kMaxRows)
MAX_E = 256  # experts at most (kMaxE)
COMBINE_ROWS = 8  # rows of a combine item (kCombineRows)
R_BUCKETS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16)  # rows a thread holds
CONSUMERS = 128  # consumer threads a block, each 2 columns (kConsumers)
MAP_BYTES = 3 * 128  # a W_down's tensor maps: one an item width

# per W_down, by (device, data_ptr, E, F, D): its tensor maps.  A map holds
# only the address, the shape and the strides, so the key names it fully.
_MAPS: Dict[tuple, ctypes.Array] = {}
_MAX_MAPS = 4096


def item_width(n: int) -> int:
    """Columns of a down item of ``n`` rows: 128 up to 32 rows, 64 up to
    64, else 32, so that no item holds more than 32 x 128 (row, column)
    pairs; its ``256 // width`` row groups hold ``thread_rows`` rows a
    thread."""
    return 128 if n <= 32 else 64 if n <= 64 else 32


def thread_rows(n: int, width: int) -> int:
    """R: the least of ``R_BUCKETS`` that holds an item's ``n`` rows in its
    ``256 // width`` row groups."""
    need = -(-n // (2 * CONSUMERS // width))
    return next(r for r in R_BUCKETS if r >= need)


def item_cost(n: int) -> int:
    """The rank key of an expert of ``n`` rows in the work list: its first
    item's rows a thread (its fmaf an F row), then its width (its bytes);
    the costliest go first."""
    if n == 0:
        return 0
    m = min(n, MAX_ROWS)
    width = item_width(m)
    return -(-m * width // 256) * 1024 + width


def plan(combine: torch.Tensor, D: int) -> Dict[str, Any]:
    """The work list the kernel builds on the card from ``combine [M, E]``
    (nonzero weights are the routed pairs), in the order its blocks take
    it: the experts ranked by ``item_cost``, costliest first, ties to the
    lower expert; each expert's rows in ascending order, in chunks of
    ``MAX_ROWS``, each chunk's column tiles (``item_width`` wide) in
    order; then the combine items.  ``{"rows": [E] rows an
    expert, "order": experts,
    "items": [{"e", "rows" (row indices), "c0", "width", "R"}],
    "combine_items": n}``.  A reckoning on the host (it syncs), for tests
    and reports; the wrapper never calls it."""
    pick = (combine != 0).cpu().numpy()
    M, E = pick.shape
    cnt = pick.sum(0)
    order = sorted(range(E), key=lambda e: (-item_cost(int(cnt[e])), e))
    items: List[Dict[str, Any]] = []
    for e in order:
        rows = np.flatnonzero(pick[:, e])
        for first in range(0, len(rows), MAX_ROWS):
            chunk = rows[first:first + MAX_ROWS]
            width = item_width(len(chunk))
            R = thread_rows(len(chunk), width)
            items += [{"e": e, "rows": chunk.tolist(), "c0": c0,
                       "width": width, "R": R}
                      for c0 in range(0, D, width)]
    return {"rows": cnt.tolist(), "order": order, "items": items,
            "combine_items": -(-D // TD) * -(-M // COMBINE_ROWS)}


def moe_down_combine_bytes(h: torch.Tensor, w_down: torch.Tensor,
                           combine: torch.Tensor) -> int:
    """The least device-memory bytes of one call on these inputs: the
    ``h`` rows and ``W_down`` slices of the (row, expert) pairs with a
    nonzero weight read once, ``combine`` read once, ``out`` written once
    (bf16)."""
    pick = combine != 0
    F, D = w_down.shape[1], w_down.shape[2]
    n_pairs = int(pick.sum())
    n_experts = int(pick.any(0).sum())
    M, E = combine.shape
    return 2 * (n_pairs * F + n_experts * F * D + M * E + M * D)


def _check(h: torch.Tensor, w_down: torch.Tensor,
           combine: torch.Tensor) -> None:
    """Raise on what the kernel does not take: bf16, contiguous, 16-byte
    aligned ``h [M, E, F]``, ``w_down [E, F, D]``, ``combine [M, E]`` on
    one device, F a multiple of ``FC``, D of 8, E of 8 up to ``MAX_E``."""
    for name, t in (("h", h), ("w_down", w_down), ("combine", combine)):
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bf16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes")
    if h.dim() != 3 or w_down.dim() != 3 or combine.dim() != 2:
        raise ValueError(f"shapes: h {tuple(h.shape)} (want [M, E, F]), "
                         f"w_down {tuple(w_down.shape)} ([E, F, D]), "
                         f"combine {tuple(combine.shape)} ([M, E])")
    M, E, F = h.shape
    if w_down.shape[:2] != (E, F) or combine.shape != (M, E):
        raise ValueError(f"shapes: h {tuple(h.shape)}, w_down "
                         f"{tuple(w_down.shape)}, combine "
                         f"{tuple(combine.shape)}")
    D = w_down.shape[2]
    if F % FC or D % 8 or F == 0 or D == 0:
        raise ValueError(f"the kernel takes F a multiple of {FC} and D of 8, "
                         f"got F = {F}, D = {D}")
    if E % 8 or not 0 < E <= MAX_E:
        raise ValueError(f"the kernel takes E a multiple of 8 up to {MAX_E} "
                         f"experts, got E = {E}")


def _weight_maps(lib, w: torch.Tensor) -> ctypes.Array:
    key = (w.device.index, w.data_ptr(), *w.shape)
    maps = _MAPS.get(key)
    if maps is None:
        if len(_MAPS) >= _MAX_MAPS:
            _MAPS.clear()
        maps = ctypes.create_string_buffer(MAP_BYTES)
        _build.check(lib, lib.moe_weight_map(w.data_ptr(), *w.shape, maps),
                     f"moe_weight_map ({tuple(w.shape)})")
        _MAPS[key] = maps
    return maps


def _launch(h: torch.Tensor, w_down: torch.Tensor, combine: torch.Tensor,
            out_dtype: Optional[torch.dtype] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch: ``(out [M, D], ys [M, E, D])``, ``out`` bf16 (float32
    with ``out_dtype=torch.float32``), ``ys`` bf16, the kernel's scratch of
    each routed pair's ``y`` (the others unwritten)."""
    global launches
    _check(h, w_down, combine)
    f32 = _out_f32(out_dtype)
    M, E, F = h.shape
    D = w_down.shape[2]
    out = torch.empty((M, D), dtype=torch.float32 if f32 else torch.bfloat16,
                      device=h.device)
    ys = torch.empty((M, E, D), dtype=torch.bfloat16, device=h.device)
    if M == 0:
        return out, ys
    # the next item, then the columns done in each 128-column tile
    counters = torch.zeros(1 + -(-D // TD), dtype=torch.int32,
                           device=h.device)
    lib = _build.load("moe")
    err = lib.moe_down_combine(h.data_ptr(), _weight_maps(lib, w_down),
                               combine.data_ptr(), ys.data_ptr(),
                               counters.data_ptr(), out.data_ptr(), M, E, F,
                               D, int(f32), stream_ptr(h.device))
    _build.check(lib, err, f"moe_down_combine (h {tuple(h.shape)}, w_down "
                 f"{tuple(w_down.shape)})")
    launches += 1
    return out, ys


def _out_f32(out_dtype: Optional[torch.dtype]) -> bool:
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or float32, got {out_dtype}")
    return out_dtype == torch.float32


def moe_down_combine_backward(h: torch.Tensor, w_down: torch.Tensor,
                              combine: torch.Tensor, y: torch.Tensor,
                              dy: torch.Tensor, needs=(True, True, True)
                              ) -> Tuple[Optional[torch.Tensor], ...]:
    """``(dh, dw_down, dcombine)`` for the cotangent ``dy [M, D]`` bf16:
    the JAX VJP of ``src/repro/nn/moe.py:76-78``'s two einsums in their
    roundings, as ``torch.bmm`` over the experts (XLA's dots, no Pallas
    kernel, as ``linear.linear_backward``).  ``d_eo[m, e] = bf16(dy[m] *
    c[m, e])``; ``dh[m, e] = bf16(d_eo[m, e] @ W_down[e]^T)``;
    ``dW_down[e] = bf16(sum_m h[m, e]^T d_eo[m, e])``; ``dc[m, e] =
    bf16(<y[m, e], dy[m]>)`` on the routed pairs, 0 where ``c`` is 0 (the
    forward never formed that ``y``, ROADMAP C.10; the router reads only
    the routed pairs' ``dc``).  ``y [M, E, D]`` is the forward's bf16
    expert outputs; ``needs`` picks the gradients computed."""
    d_eo = (dy[:, None, :] * combine[:, :, None]).transpose(0, 1)  # [E, M, D]
    dh = dw = dc = None
    if needs[0]:
        dh = torch.bmm(d_eo, w_down.transpose(1, 2)).transpose(0, 1)
    if needs[1]:
        dw = torch.bmm(h.permute(1, 2, 0), d_eo)
    if needs[2]:
        dc = torch.bmm(y, dy[:, :, None])[:, :, 0]
        dc = torch.where(combine != 0, dc, torch.zeros_like(dc))
    return dh, dw, dc


# The plain expert products are one registered operator on the CPU and on
# meta tensors, so that ``torch.utils.flop_counter`` counts their FLOPs
# (its F-ordered loop is elementwise, which it does not count); the
# dry-run planner counts a step's FLOPs on meta tensors.
@torch.library.custom_op("repro_torch::moe_expert_out", mutates_args=())
def _expert_out(h: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """``ref.moe_expert_out_ref`` as an operator."""
    return moe_expert_out_ref(h, w_down)


@_expert_out.register_fake
def _(h, w_down):
    return h.new_empty((h.shape[0], h.shape[1], w_down.shape[2]),
                       dtype=torch.bfloat16)


@register_flop_formula(torch.ops.repro_torch.moe_expert_out)
def _expert_out_flops(h_shape, w_shape, *args, **kwargs) -> int:
    """``2 M E F D``: every expert's down product, as the JAX dense
    einsum (the kernel skips the experts a row does not pick)."""
    M, E, F = h_shape
    return 2 * M * E * F * w_shape[2]


def _plain(h: torch.Tensor, w_down: torch.Tensor, combine: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, y)`` of the plain version (``ref.moe_down_combine_ref``)."""
    y = _expert_out(h, w_down)
    return moe_combine_ref(y, combine, out_dtype), y


class _DownCombine(torch.autograd.Function):
    """``moe_down_combine`` with a gradient: the forward is the kernel's
    one launch (the plain version on the CPU), bitwise what the call
    without a gradient gives; it keeps the launch's ``ys`` (the routed
    pairs' bf16 ``y``, M x E x D x 2 bytes) for the backward, which so
    recomputes nothing; the backward is ``moe_down_combine_backward``."""

    @staticmethod
    def forward(ctx, h, w_down, combine):
        if h.device.type in ("cpu", "meta"):
            out, y = _plain(h, w_down, combine)
        else:
            out, y = _launch(h, w_down, combine)
        ctx.save_for_backward(h, w_down, combine, y)
        return out

    @staticmethod
    def backward(ctx, dy):
        h, w_down, combine, y = ctx.saved_tensors
        return moe_down_combine_backward(h, w_down, combine, y, dy,
                                         ctx.needs_input_grad)


def moe_down_combine(h: torch.Tensor, w_down: torch.Tensor,
                     combine: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``h [M, E, F]``, ``w_down [E, F, D]``, ``combine [M, E]`` bf16 ->
    ``[M, D]`` bf16, or with ``out_dtype=torch.float32`` the float32 sums
    before that rounding: the kernel for CUDA tensors (one launch, after
    the counters' zeroing), the plain version for CPU tensors.  Where
    autograd records (grad mode on and an input requiring grad), the call
    carries a gradient (``_DownCombine``, bf16 out); the forward is the
    same launch."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, w_down, combine)):
        if _out_f32(out_dtype):
            raise ValueError("the float32 partial is a serving output; the "
                             "call with a gradient gives bf16")
        return _DownCombine.apply(h, w_down, combine)
    if h.device.type in ("cpu", "meta"):
        _out_f32(out_dtype)
        return _plain(h, w_down, combine, out_dtype)[0]
    return _launch(h, w_down, combine, out_dtype)[0]
