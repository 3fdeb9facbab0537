"""CUDA kernel: TCAM-style ternary match (the EB decision table).

Replaces ``ternary_match_pallas`` (``src/repro/kernels/ternary_match.py``),
whose grid walked row blocks on a sequential axis and carried the running
``max(prio*256 + action)`` in VMEM scratch.

On the H100 the work is about ``B*N*(2W + 2)`` integer operations
(and/compare per word, select/max per row) against ``B*(W + 1)*4`` bytes
of keys and actions, so it is bound by integer operations.  Design: one
thread per key, key words in registers, running max in a register from -1;
the block stages tiles of ``values``, ``masks`` and ``prio_action`` in
shared memory, and every thread of a warp reads the same row (a broadcast).
The tile loop inside the block takes the place of the sequential grid axis,
since blocks run in no order on the card; priorities are unique, so the max
is order-free and bitwise.  The ragged end of ``N`` is a loop bound, not
padding rows.  Warp-cooperative row matching is later work.
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import require, stream_ptr
from .ref import ternary_match_ref

launches = 0  # kernel launches; the main-path check reads and resets it


def ternary_match(keys: torch.Tensor, values: torch.Tensor, masks: torch.Tensor,
                  prio_action: torch.Tensor, default_action: int) -> torch.Tensor:
    """keys [B, W]; rows (values, masks) [N, W] int32 bits; prio_action [N]
    int32 -> actions [B] int32."""
    global launches
    if keys.device.type == "cpu":
        return ternary_match_ref(keys, values, masks, prio_action, default_action)
    dev = keys.device
    for t, name, nd in ((keys, "keys", 2), (values, "values", 2),
                        (masks, "masks", 2), (prio_action, "prio_action", 1)):
        require(t, name, nd, dev)
    B, W = keys.shape
    N = values.shape[0]
    if values.shape != (N, W) or masks.shape != (N, W) or prio_action.shape != (N,):
        raise ValueError("rows must be [N, W] with prio_action [N]: got "
                         f"{tuple(values.shape)} {tuple(masks.shape)} "
                         f"{tuple(prio_action.shape)} for keys {(B, W)}")
    if N == 0:
        raise ValueError("ternary_match needs at least one row (an empty "
                         "table is its default action)")
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _build.load("eb_kernels")
    err = lib.eb_ternary_match(keys.data_ptr(), values.data_ptr(),
                               masks.data_ptr(), prio_action.data_ptr(),
                               out.data_ptr(), B, N, W, int(default_action),
                               stream_ptr(dev))
    _build.check(lib, err, "ternary_match")
    launches += 1
    return out
