"""CUDA kernel: paged attention over a block-table KV cache.

Replaces ``paged_attention`` (``src/repro/kernels/paged_attention.py:107``),
which staged the whole batch's logical K/V view in VMEM and attended once,
at the last step of a sequential grid, with the jnp oracle's op sequence.

On the H100 the work is bound by device-memory bytes (decode reads each
visible K and V row once, for about 4 flops a byte;
``paged_attention_hbm_bytes``).  Design (``csrc/paged_attention.cu``): a
cluster of 8 blocks per ``(b, kv_head)`` splits the slot's logical
positions into fixed ranges; each block loads, with coalesced 16-byte
copies, only the K/V rows of its range that some query row of the slot
can see, scores all C x G query rows of the slot against them with the
oracle's roundings, and the ranks take one full-axis softmax and P.V
together through distributed shared memory, every cross-rank sum in rank
order.  Every sum's order is fixed by S and hd, so a row's result
is bitwise the same whatever B, C or the page order, and whatever the
rows no query can see hold.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from ._launch import require, stream_ptr
from .ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_hbm_bytes", "visible_rows"]

launches = 0  # kernel launches; the main-path check reads and resets it

THREADS = 256  # kThreads in the CUDA source
MAX_GROUP = 16  # query heads per KV head the kernel takes
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def visible_rows(positions, window: int, S: int) -> np.ndarray:
    """K/V rows each slot's launch reads: the length of ``[min over the
    slot's rows of max(0, pos - window + 1), max over them of pos]``
    within ``[0, S)``; a row that sees no position (pos < 0, or past S
    with a window) makes it the whole axis.  ``positions`` [B, C]."""
    pos = np.asarray(positions, np.int64)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros_like(pos)
    hi = np.minimum(pos, S - 1)
    blind = lo > hi
    lo, hi = np.where(blind, 0, lo), np.where(blind, S - 1, hi)
    return hi.max(axis=1) - lo.min(axis=1) + 1


def paged_attention_hbm_bytes(B: int, C: int, H: int, KV: int, hd: int,
                              n_ps: int, page: int, *, pool_bytes: int,
                              quantized: bool, act_bytes: int,
                              positions=None, window: int = 0) -> int:
    """Device-memory bytes one launch of this kernel moves.

    The K and V rows of each slot's visible range (``visible_rows`` of
    ``positions`` and ``window``; with no positions, every position of
    every slot, as when each slot is at the end of its table), once each
    for all its query rows, with their float32 scale planes when
    quantized; plus q read and the output written once, the block table
    and the positions.  No two slots share a page here, so this is also
    the least any kernel must move.
    """
    if positions is None:
        rows = B * n_ps * page
    else:
        rows = int(visible_rows(positions, window, n_ps * page).sum())
    cells = rows * KV
    kv_bytes = 2 * cells * hd * pool_bytes
    scale_bytes = 2 * cells * 4 if quantized else 0
    q_out = 2 * B * C * H * hd * act_bytes
    return kv_bytes + scale_bytes + q_out + (B * n_ps + B * C) * 4


def _check_pool(t: torch.Tensor, name: str, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [N, page, KV, x] "
                         f"tensor, got {tuple(t.shape)}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tbl: torch.Tensor,
                    positions: torch.Tensor, window,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, C, H, hd] bf16/f32; pools [N, page, KV, hd] bf16/f32, or int8
    with float32 scale planes [N, page, KV, 1]; block_tbl [B, n_ps] int32
    (clipped to the pool); positions [B, C] int32; window an int (0 =
    full) -> [B, C, H, hd] in q's type."""
    global launches
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tbl, positions,
                                   window, k_scale=k_scale, v_scale=v_scale)
    dev = q.device
    if q.dtype not in _Q_DTYPES or q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [B, C, H, hd] bf16/f32 "
                         f"tensor, got {q.dtype} {tuple(q.shape)}")
    B, C, H, hd = q.shape
    for t, name in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        _check_pool(t, name, dev)
        if t.dtype not in _POOL_DTYPES:
            raise TypeError(f"{name} must be float32, bfloat16 or int8, got "
                            f"{t.dtype}")
    N, page, KV, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"v_pages {v_pages.dtype} {tuple(v_pages.shape)} "
                         f"vs k_pages {k_pages.dtype} {tuple(k_pages.shape)}")
    quantized = k_pages.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("int8 pools need both scale planes; float pools "
                         "take none")
    if quantized:
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            _check_pool(t, name, dev)
            if t.dtype != torch.float32 or t.shape != (N, page, KV, 1):
                raise ValueError(f"{name} must be float32 {(N, page, KV, 1)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
    require(block_tbl, "block_tbl", 2, dev)
    require(positions, "positions", 2, dev)
    n_ps = block_tbl.shape[1]
    if (hd_k != hd or KV < 1 or H % KV or block_tbl.shape[0] != B
            or positions.shape != (B, C) or N < 1 or n_ps < 1):
        raise ValueError(
            f"shapes: q {(B, C, H, hd)}, pools {tuple(k_pages.shape)}, "
            f"block_tbl {tuple(block_tbl.shape)}, positions "
            f"{tuple(positions.shape)}")
    if H // KV > MAX_GROUP or hd > THREADS or hd % 8:
        raise ValueError(f"the kernel takes at most {MAX_GROUP} query heads "
                         f"per KV head and a head_dim that is a multiple of "
                         f"8 up to {THREADS}; got H/KV = {H // KV}, hd = {hd}")
    out = torch.empty_like(q)
    lib = _build.load("paged_attention")
    err = lib.paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tbl.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, C, H, KV, hd, N, page, n_ps, int(window),
        float(np.float32(np.sqrt(hd))), _Q_DTYPES[q.dtype],
        _POOL_DTYPES[k_pages.dtype], stream_ptr(dev))
    # a refused launch: a rank's [C*G, S/8] scores past shared memory
    _build.check(lib, err, f"paged_attention (S = {n_ps * page} positions, "
                 f"{C} x {H // KV} query rows a slot)")
    launches += 1
    return out
