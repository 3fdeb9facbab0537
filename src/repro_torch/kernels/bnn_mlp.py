"""CUDA kernel: XNOR + popcount binarized matmul (DM BNN layer, Eq. 8).

Replaces ``bnn_popcount_matmul_pallas`` (``src/repro/kernels/bnn_mlp.py``),
which held ``(block_b, block_n)`` tiles with all packed words in VMEM and
ran XOR + NOT + ``population_count`` on the VPU, keeping the MXU out so the
path stays multiplication-free as on the switch.

On the H100 the work is ``B*N*W`` XNOR-popcounts; with a few words per row
the ``[B, N]`` int32 counts written back are most of the bytes, so it is
bound by device-memory bytes.  Design: ``__popc(~(x ^ w))`` on the CUDA
cores, no multiplication; the packed ``[N, W]`` weights sit in shared
memory (read through the cache past 48 KB), each block walks tiles of batch
rows with the tile's x words loaded coalesced, and consecutive threads take
consecutive ``n`` so the counts are stored coalesced.  Every word counts as
it is: pad bits, zero in x and in w, count as matches (``bnn_forward``
subtracts them).
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import require, stream_ptr
from .ref import bnn_popcount_matmul_ref

launches = 0  # kernel launches; the main-path check reads and resets it


def bnn_popcount_matmul(x_packed: torch.Tensor,
                        w_packed: torch.Tensor) -> torch.Tensor:
    """x [B, W], w [N, W] (uint32 bits as int32) -> counts [B, N] int32."""
    global launches
    if x_packed.device.type == "cpu":
        return bnn_popcount_matmul_ref(x_packed, w_packed)
    dev = x_packed.device
    require(x_packed, "x_packed", 2, dev)
    require(w_packed, "w_packed", 2, dev)
    B, W = x_packed.shape
    N, Ww = w_packed.shape
    if Ww != W or W < 1:
        raise ValueError(f"w_packed {tuple(w_packed.shape)} vs x_packed "
                         f"{(B, W)}")
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    lib = _build.load("lb_dm_kernels")
    err = lib.bnn_popcount_matmul(x_packed.data_ptr(), w_packed.data_ptr(),
                                  out.data_ptr(), B, N, W, stream_ptr(dev))
    _build.check(lib, err, "bnn_popcount_matmul")
    launches += 1
    return out
