"""CUDA kernel: the serve step's products, ``y = x @ W``, row-invariant.

Replaces no Pallas kernel: the JAX package leaves the step's products to
XLA (``jnp`` dots in ``nn/attention.py`` and ``nn/mlp.py``, the head's
bf16 x bf16 einsum with float32 accumulation at ``arch/model.py:330``).
The port runs its own because its invariants (chunked prefill equal to
token-by-token, speculative verify equal to plain decode) need a row's
bits to depend on that row and ``W`` alone, which cuBLAS does not promise:
it picks kernels and split-K by shape.

Bound on the H100 by bytes: at the serve shapes each weight element is used
M <= 256 times.  Design (``csrc/linear.cu``): tensor-core products
(``mma.sync.m16n8k16``, bf16 in, float32 accumulate) of a block's 128
columns over one fixed K slice, the slice's weights streamed once through
shared memory and run against every row the block holds; the S slices'
float32 partials are added in the order s = 0..S-1 by a second pass.
``plan(K, N)`` fixes the slices from ``(K, N)`` alone, so no M changes the
order of any row's sums.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._launch import stream_ptr
from .ref import linear_ref

__all__ = ["linear", "plan", "row_tiles", "linear_hbm_bytes"]

launches = 0  # kernel launches; the main-path check reads and resets it

BN = 128  # columns a block (kBN in the CUDA source)
KC = 64  # K rows a pipeline stage (kKC)
TARGET_BLOCKS = 132  # blocks S aims at: one an SM of an H100
MAX_ROW_TILES = 8  # 16-row tiles a block holds in registers


def plan(K: int, N: int) -> Tuple[int, int]:
    """``(KS, S)``: the K slice length (a multiple of ``KC``) and the
    number of slices, from ``(K, N)`` alone: about ``TARGET_BLOCKS``
    blocks over the ``ceil(N / BN)`` column tiles."""
    tiles = -(-N // BN)
    S = min(max(1, round(TARGET_BLOCKS / tiles)), -(-K // KC))
    KS = KC * max(1, round(K / (S * KC)))
    return KS, -(-K // KS)


def row_tiles(M: int) -> int:
    """16-row tiles a block holds (1, 2, 4 or 8): the fewest that cover M,
    at most ``MAX_ROW_TILES``; more rows take more row groups.  It sets
    the loop around each row's sums, never their order."""
    t = 1
    while t < MAX_ROW_TILES and 16 * t < M:
        t *= 2
    return t


def linear_hbm_bytes(M: int, K: int, N: int, out_bytes: int) -> int:
    """The least device-memory bytes of one product: x and W read once,
    y written once (bf16 operands)."""
    return 2 * M * K + 2 * K * N + out_bytes * M * N


def linear(x: torch.Tensor, w: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``: in x's type, or with ``out_dtype =
    torch.float32`` the float32 product of the bf16 values (the LM head).
    On the card both are contiguous bf16 and K and N multiples of 8."""
    global launches
    if x.device.type == "cpu":
        return linear_ref(x, w, out_dtype)
    dev = x.device
    if w.device != dev:
        raise ValueError(f"w is on {w.device}, x on {dev}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 operands, got x {x.dtype}, "
                        f"w {w.dtype}")
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or float32, got {out_dtype}")
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"shapes: x {tuple(x.shape)}, w {tuple(w.shape)}")
    K, N = w.shape
    if K % 8 or N % 8:
        raise ValueError(f"the kernel takes K and N multiples of 8 (16-byte "
                         f"rows), got K = {K}, N = {N}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must start on 16 bytes")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    f32 = out_dtype == torch.float32
    out = torch.empty((M, N), dtype=torch.float32 if f32 else torch.bfloat16,
                      device=dev)
    if M == 0:
        return out.reshape(*x.shape[:-1], N)
    KS, S = plan(K, N)
    ws = (torch.empty((S, M, N), dtype=torch.float32, device=dev)
          if S > 1 else None)
    lib = _build.load("linear")
    err = lib.linear(x2.data_ptr(), w.data_ptr(),
                     ws.data_ptr() if ws is not None else None,
                     out.data_ptr(), M, K, N, KS, S, row_tiles(M), int(f32),
                     stream_ptr(dev))
    _build.check(lib, err, f"linear ([{M}, {K}] x [{K}, {N}])")
    launches += 1
    return out.reshape(*x.shape[:-1], N)
