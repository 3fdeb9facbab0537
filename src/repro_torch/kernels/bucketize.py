"""CUDA kernel: EB feature-table encode (value -> code).

Replaces ``bucketize_pallas`` (``src/repro/kernels/bucketize.py``), which
held a batch tile and the whole ``[F, T]`` threshold matrix in VMEM and
compare-counted on the VPU.

Contract, on both devices, for any row: ``codes[b, f] = #{t : thr[f, t]
<= v[b, f]}`` over all ``T`` columns, the INT32_MAX padding included, so
``v == INT32_MAX`` gives the oracle's count.  On a non-decreasing row (every
row the EB mappers make) that count is the ``upper_bound`` of v, which
the kernel binary-searches; each block marks the rows that decrease
somewhere while it stages them, and compare-counts those.

On the H100 the work is ``B*F*log2(T)`` compares over ``B*F*4`` bytes in
and out: bound by device-memory bytes.  Design: a persistent grid whose
blocks stage the rows once in shared memory (opting in past 48 KB; past
96 KB read through L1); each thread takes 4 consecutive flat elements with
one 16-byte load and store (element by element at an unaligned view or
the last partial quad), runs four interleaved branchless binary searches
(a compare-count on a marked row), and advances its feature index by the
grid stride instead of a modulo.  No host check and no sync.
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import require, stream_ptr
from .ref import bucketize_ref

launches = 0  # kernel launches; the main-path check reads and resets it


def bucketize(values: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """values [B, F] int32, thresholds [F, T] int32 (any order) -> codes
    [B, F] int32."""
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
