"""CUDA kernel: LB feature tables + final-stage accumulate.

Replaces ``lb_lookup_pallas`` (``src/repro/kernels/lb_lookup.py``), which
turned each feature's lookup into a one-hot x LUT matmul in float32 on the
MXU (exact only while ``F * 2^action_bits < 2^24``, so the JAX package
falls back to its gather oracle above 16 action bits).

On the H100 the work is ``B*F*K`` int32 adds over ``B*F*4 + B*K*4`` bytes
of codes and sums (the LUT is small), so it is bound by device-memory
bytes.  Design: an int32 gather-accumulate, exact at every
``action_bits``; a block stages the ``[F, V, K]`` LUT in shared memory
while it fits beside the codes tile (48 KB), else reads it through the
cache, walks tiles of batch rows, loads each tile's codes coalesced, and
has consecutive threads store consecutive ``(b, k)`` sums.  Contract:
codes lie in ``[0, V)`` (the LB predictor clips first).
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import require, stream_ptr
from .ref import lb_lookup_ref

launches = 0  # kernel launches; the main-path check reads and resets it


def lb_lookup(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes [B, F] int32 in [0, V), luts [F, V, K] int32 -> sums [B, K] int32."""
    global launches
    if codes.device.type == "cpu":
        return lb_lookup_ref(codes, luts)
    dev = codes.device
    require(codes, "codes", 2, dev)
    require(luts, "luts", 3, dev)
    B, F = codes.shape
    Fl, V, K = luts.shape
    if Fl != F:
        raise ValueError(f"luts {tuple(luts.shape)} vs codes {(B, F)}")
    if luts.numel() >= 2**31:
        raise ValueError(f"luts {tuple(luts.shape)} exceed int32 indexing")
    out = torch.empty((B, K), dtype=torch.int32, device=dev)
    lib = _build.load("lb_dm_kernels")
    err = lib.lb_lookup(codes.data_ptr(), luts.data_ptr(), out.data_ptr(),
                        B, F, V, K, stream_ptr(dev))
    _build.check(lib, err, "lb_lookup")
    launches += 1
    return out
