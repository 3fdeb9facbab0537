"""CUDA kernel: the EB pipeline (encode + pack + match) in one launch.

Replaces ``fused_eb_pallas`` (``src/repro/kernels/fused_eb.py``), which
kept thresholds, the key layout and all ternary rows of a gate-sized table
in VMEM and baked the ``(word, off, width)`` layout into the kernel body.

On the H100 it does the work of ``bucketize`` and ``ternary_match`` and is
bound, like the latter, by the ``B*N*(2W + 2)`` integer operations of the
match; the codes and keys never touch device memory.  Design: one thread
per row computes its F codes against thresholds staged in shared memory
(read through the cache when they exceed 16 KB), packs them into W key
words in registers from a small ``[F, 3]`` int32 layout array passed in,
then matches them against row tiles in shared memory with a register
running max.  Tables whose rows exceed the shared-memory budget are walked
in tiles, not refused.  ``identity`` takes the raw values as codes (KM/KNN
quadtree tables).  The TPU's lane-aligned batch tile (``gate_block_b``)
has no counterpart: the result does not depend on the block size.
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import require, stream_ptr
from .ref import fused_eb_ref

launches = 0  # kernel launches; the main-path check reads and resets it


def fused_eb(values: torch.Tensor, thresholds: torch.Tensor, rows_v: torch.Tensor,
             rows_m: torch.Tensor, prio_action: torch.Tensor, layout: torch.Tensor,
             default_action: int, identity: bool = False) -> torch.Tensor:
    """values [B, F] int32, thresholds [F, T], rows [N, W] int32 bits,
    prio_action [N], layout [F, 3] int32 (word, off, width) -> [B] int32."""
    global launches
    if values.device.type == "cpu":
        return fused_eb_ref(values, thresholds, rows_v, rows_m, prio_action,
                            layout, default_action, identity)
    dev = values.device
    for t, name, nd in ((values, "values", 2), (thresholds, "thresholds", 2),
                        (rows_v, "rows_v", 2), (rows_m, "rows_m", 2),
                        (prio_action, "prio_action", 1), (layout, "layout", 2)):
        require(t, name, nd, dev)
    B, F = values.shape
    N, W = rows_v.shape
    if (thresholds.shape[0] != F or layout.shape != (F, 3)
            or rows_m.shape != (N, W) or prio_action.shape != (N,)):
        raise ValueError(
            f"shapes: values {(B, F)}, thresholds {tuple(thresholds.shape)}, "
            f"layout {tuple(layout.shape)}, rows {tuple(rows_v.shape)}/"
            f"{tuple(rows_m.shape)}, prio_action {tuple(prio_action.shape)}")
    if N == 0:
        raise ValueError("fused_eb needs at least one row (an empty table is "
                         "its default action)")
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _build.load("eb_kernels")
    err = lib.eb_fused(values.data_ptr(), thresholds.data_ptr(),
                       rows_v.data_ptr(), rows_m.data_ptr(),
                       prio_action.data_ptr(), layout.data_ptr(), out.data_ptr(),
                       B, F, thresholds.shape[1], N, W, int(bool(identity)),
                       int(default_action), stream_ptr(dev))
    _build.check(lib, err, "fused_eb")
    launches += 1
    return out
