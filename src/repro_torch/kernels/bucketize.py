"""CUDA kernel: EB feature-table encode (value -> code).

Replaces ``bucketize_pallas`` (``src/repro/kernels/bucketize.py``), which
held a batch tile and the whole ``[F, T]`` threshold matrix in VMEM and
compare-counted on the VPU.

On the H100 the work is ``B*F*T`` integer compares over ``B*F*4`` bytes in
and out, and with ``T`` a few dozen it is bound by device-memory bytes, not
by operations.  Design: one thread per ``(b, f)`` so that loads and stores
of ``values``/``codes`` are coalesced; the block stages the thresholds in
shared memory (in tiles when they exceed 48 KB) and counts over all ``T``
columns, the INT32_MAX padding included, so ``v == INT32_MAX`` gives the
oracle's count.  Vectorised 16-byte loads are later work.
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import require, stream_ptr
from .ref import bucketize_ref

launches = 0  # kernel launches; the main-path check reads and resets it


def bucketize(values: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """values [B, F] int32, thresholds [F, T] int32 -> codes [B, F] int32."""
    global launches
    if values.device.type == "cpu":
        return bucketize_ref(values, thresholds)
    dev = values.device
    require(values, "values", 2, dev)
    require(thresholds, "thresholds", 2, dev)
    B, F = values.shape
    if thresholds.shape[0] != F:
        raise ValueError(f"thresholds {tuple(thresholds.shape)} vs F={F}")
    out = torch.empty((B, F), dtype=torch.int32, device=dev)
    lib = _build.load("eb_kernels")
    err = lib.eb_bucketize(values.data_ptr(), thresholds.data_ptr(),
                           out.data_ptr(), B, F, thresholds.shape[1],
                           stream_ptr(dev))
    _build.check(lib, err, "bucketize")
    launches += 1
    return out
