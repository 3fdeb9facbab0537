"""CUDA kernel: XNOR + popcount binarized matmul (DM BNN layer, Eq. 8).

Replaces ``bnn_popcount_matmul_pallas`` (``src/repro/kernels/bnn_mlp.py``),
which held ``(block_b, block_n)`` tiles with all packed words in VMEM and
ran XOR + NOT + ``population_count`` on the VPU, keeping the MXU out so the
path stays multiplication-free as on the switch.

On the H100 the work is ``B*N*W`` XNOR-popcounts.  Writing the ``[B, N]``
int32 counts makes the plain layer bound by device-memory bytes, and the
glue around it (bit packing, the sign) costs more again, so the kernel
fuses both neighbours in, each a mode of the same launch:

* input prologue (``in_bits > 0``): x is the int32 features ``[B, F]``;
  the thread builds the row's packed words in registers (bit
  ``f*in_bits + j`` = bit j of ``x[b, f]``, LSB-first, pad bits zero);
* epilogue: ``dot = 2*(counts - (32*W - n_in)) - n_in``; ``"sign"`` packs
  ``dot >= 0`` into ``[B, ceil(N/32)]`` words (a hidden layer),
  ``"score"`` writes dot ``[B, N]`` (the last layer); the counts never
  reach device memory.

Fused, a layer moves a few bytes a row and is bound by the popcounts.
Design: ``__popc(~(x ^ w))`` on the CUDA cores, no multiplication; a
persistent grid sized for full occupancy; the ``[N, W]`` weights staged
once per block in shared memory (read through the cache past 48 KB) and
read as warp broadcasts; a thread holds its row's W words in registers
(one vector load, W <= 8 compiled per W, wider rows in chunks of 8 words)
and makes 4 consecutive outputs a step, stored as one 16-byte vector when
``N % 4 == 0``, with no division per output.  Counts mode: one thread per
4-output piece, so consecutive threads store consecutive 16 bytes; fused
modes: one thread per row, so a thread owns the row's sign bits.  Every
word counts as it is: pad bits, zero in x and in w, count as matches.
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import aligned16, require, stream_ptr
from .ref import BNN_EPILOGUES, bnn_popcount_matmul_ref

launches = 0  # kernel launches; the main-path check reads and resets it


def bnn_popcount_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                        in_bits: int = 0, epilogue: str = "counts",
                        n_in: int = 0) -> torch.Tensor:
    """x [B, W] packed rows, or the int32 features [B, F] when ``in_bits``
    (1-32) is given; w [N, W] (uint32 bits as int32) -> int32 counts
    [B, N], or with ``epilogue`` the layer's sign words [B, ceil(N/32)]
    (``"sign"``) or scores [B, N] (``"score"``) over fan-in ``n_in``."""
    global launches
    if epilogue not in BNN_EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {BNN_EPILOGUES}")
    if in_bits and not 1 <= in_bits <= 32:
        raise ValueError(f"in_bits {in_bits} not in [1, 32]")
    if x.device.type == "cpu":
        return bnn_popcount_matmul_ref(x, w_packed, in_bits, epilogue, n_in)
    dev = x.device
    require(x, "x", 2, dev)
    require(w_packed, "w_packed", 2, dev)
    B, cols = x.shape
    N, W = w_packed.shape
    words = -(-cols * in_bits // 32) if in_bits else cols
    if W != words or W < 1:
        raise ValueError(f"w_packed {tuple(w_packed.shape)} vs x {(B, cols)}"
                         f" (in_bits={in_bits}: {words} words a row)")
    out_cols = -(-N // 32) if epilogue == "sign" else N
    out = torch.empty((B, out_cols), dtype=torch.int32, device=dev)
    x, w_packed = aligned16(x), aligned16(w_packed)
    lib = _build.load("lb_dm_kernels")
    err = lib.bnn_popcount_matmul(x.data_ptr(), w_packed.data_ptr(),
                                  out.data_ptr(), B, N, W,
                                  cols if in_bits else 0, in_bits, int(n_in),
                                  BNN_EPILOGUES.index(epilogue),
                                  stream_ptr(dev))
    _build.check(lib, err, "bnn_popcount_matmul")
    launches += 1
    return out
