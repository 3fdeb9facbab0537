"""CUDA kernel: the serve step's products, ``y = x @ W``, row-invariant.

Replaces no Pallas kernel: the JAX package leaves the step's products to
XLA (``jnp`` dots in ``nn/attention.py`` and ``nn/mlp.py``, the head's
bf16 x bf16 einsum with float32 accumulation at ``arch/model.py:330``).
The port runs its own because its invariants (chunked prefill equal to
token-by-token, speculative verify equal to plain decode) need a row's
bits to depend on that row and ``W`` alone, which cuBLAS does not promise:
it picks kernels and split-K by shape.

Bound on the H100 by bytes: at the serve shapes each weight element is used
M <= 256 times.  Design (``csrc/linear.cu``): a block owns 128 columns, one
fixed K slice and up to 128 rows; a producer warp streams the slice's W
and x tiles into a 96 KB shared-memory ring with TMA (4 stages of 64 K
rows, or 6 of 32 with two row tiles), and one consumer warpgroup a 64-row
tile runs ``wgmma.m64n128k16`` (bf16 in, float32 accumulate) on them.  The
S slices of a column tile form a thread-block cluster that adds its
float32 partials in the order s = 0..S-1 through distributed shared
memory.  ``plan(K, N)`` fixes the slices from ``(K, N)`` alone, and the
instruction shape is the same for every M, so no M changes the order of
any row's sums.  ``linear_group`` computes up to three products of one
``x`` in one launch (q/k/v, gate/up), each with its own plan, so each
output is bitwise its lone launch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import _build
from ._launch import stream_ptr
from .ref import linear_ref

__all__ = ["linear", "linear_group", "plan", "row_tiles", "linear_hbm_bytes"]

launches = 0  # kernel launches; the main-path check reads and resets it

BN = 128  # columns a block (kBN in the CUDA source)
KC = 64  # the K slices' granule (a multiple of every stage's K rows)
BM = 64  # rows a consumer warpgroup (kBM)
MIN_BLOCKS = 48  # blocks a product gets at least, where K allows
MAX_SLICE = 1600  # K rows a slice at most, where S allows
MAX_SLICES = 8  # a column tile's slices are one cluster (kMaxSlices)
MAX_GROUP = 3  # products one launch computes (kMaxGroup)
MAP_BYTES = 2 * 128  # a weight's two CUtensorMaps (64- and 32-row boxes)

# per group of weights, by each one's (device, data_ptr, K, N): the ctypes
# arrays its launches pass, the weights' tensor maps among them.  A map
# holds only the address, the shape and the strides, so the key names it
# fully.
_GROUPS: Dict[tuple, tuple] = {}
_MAX_GROUPS = 4096


def plan(K: int, N: int) -> Tuple[int, int]:
    """``(KS, S)``: the K slice length (a multiple of ``KC``) and the
    number of slices, from ``(K, N)`` alone.  S is the least power of two
    (up to ``MAX_SLICES``) that gives the ``ceil(N / BN)`` column tiles at
    least ``MIN_BLOCKS`` blocks and each slice at most ``MAX_SLICE`` K
    rows, and ``S == ceil(K / KS)``.  On the H100 (PERF.md §6, PR 20):
    wq / wo split 4 ways, wk / wv and w_down 8, w_gate / w_up and the
    head not at all."""
    tiles = -(-N // BN)
    cap = min(MAX_SLICES, -(-K // KC))
    S = 1
    while 2 * S <= cap and (tiles * S < MIN_BLOCKS
                            or KC * -(-K // (S * KC)) > MAX_SLICE):
        S *= 2
    while True:  # the largest power of two <= S whose slices come out even
        KS = KC * -(-K // (S * KC))
        if -(-K // KS) == S:
            return KS, S
        S //= 2


def row_tiles(M: int) -> int:
    """64-row tiles a block holds (1 or 2): one up to 64 rows, else two;
    more rows take more row groups.  It sets the loop around each row's
    sums, never their order."""
    return 1 if M <= BM else 2


def linear_hbm_bytes(M: int, K: int, N: int, out_bytes: int) -> int:
    """The least device-memory bytes of one product: x and W read once,
    y written once (bf16 operands)."""
    return 2 * M * K + 2 * K * N + out_bytes * M * N


def _check(x: torch.Tensor, ws: Sequence[torch.Tensor],
           out_dtype: Optional[torch.dtype]) -> None:
    if not 1 <= len(ws) <= MAX_GROUP:
        raise ValueError(f"a launch takes 1 to {MAX_GROUP} weights, got "
                         f"{len(ws)}")
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or float32, got {out_dtype}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 operands, got x {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x and w must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x and w must start on 16 bytes")
    for w in ws:
        if w.device != x.device:
            raise ValueError(f"w is on {w.device}, x on {x.device}")
        if w.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bf16 operands, got x "
                            f"{x.dtype}, w {w.dtype}")
        if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
            raise ValueError(f"shapes: x {tuple(x.shape)}, w "
                             f"{tuple(w.shape)}")
        K, N = w.shape
        if K % 8 or N % 8:
            raise ValueError(f"the kernel takes K and N multiples of 8 "
                             f"(16-byte rows), got K = {K}, N = {N}")
        if not w.is_contiguous():
            raise ValueError("x and w must be contiguous")
        if w.data_ptr() % 16:
            raise ValueError("x and w must start on 16 bytes")


def _weight_map(lib, w: torch.Tensor) -> ctypes.Array:
    m = ctypes.create_string_buffer(MAP_BYTES)
    _build.check(lib, lib.linear_weight_map(w.data_ptr(), *w.shape, m),
                 f"linear_weight_map ({tuple(w.shape)})")
    return m


def _group(lib, ws: Sequence[torch.Tensor]) -> tuple:
    """(maps, Ns, KSs, Ss) as the ctypes arrays a launch passes, and the
    map buffers they point to."""
    key = tuple((w.device.index, w.data_ptr(), *w.shape) for w in ws)
    rec = _GROUPS.get(key)
    if rec is None:
        if len(_GROUPS) >= _MAX_GROUPS:
            _GROUPS.clear()
        G = len(ws)
        maps = [_weight_map(lib, w) for w in ws]
        plans = [plan(*w.shape) for w in ws]
        rec = ((ctypes.c_void_p * G)(*[ctypes.addressof(m) for m in maps]),
               (ctypes.c_int * G)(*[w.shape[1] for w in ws]),
               (ctypes.c_int * G)(*[p[0] for p in plans]),
               (ctypes.c_int * G)(*[p[1] for p in plans]), maps)
        _GROUPS[key] = rec
    return rec


def linear_group(x: torch.Tensor, ws: Sequence[torch.Tensor],
                 out_dtype: Optional[torch.dtype] = None
                 ) -> List[torch.Tensor]:
    """``[x @ w for w in ws]`` (x [..., K], each w [K, N_w]) in one launch
    on the card, each output bitwise what ``linear(x, w)`` gives; on the CPU
    the plain version of each.  In x's type, or float32 with ``out_dtype =
    torch.float32``."""
    global launches
    if x.device.type == "cpu":
        return [linear_ref(x, w, out_dtype) for w in ws]
    _check(x, ws, out_dtype)
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    dt = torch.float32 if out_dtype == torch.float32 else torch.bfloat16
    outs = [torch.empty((M, w.shape[1]), dtype=dt, device=x.device)
            for w in ws]
    shaped = [o.reshape(*x.shape[:-1], o.shape[1]) for o in outs]
    if M == 0:
        return shaped
    lib = _build.load("linear")
    maps, Ns, KSs, Ss, _ = _group(lib, ws)
    G = len(ws)
    err = lib.linear(x2.data_ptr(), M, K, G, maps,
                     (ctypes.c_void_p * G)(*[o.data_ptr() for o in outs]),
                     Ns, KSs, Ss, row_tiles(M), int(dt == torch.float32),
                     stream_ptr(x.device))
    _build.check(lib, err, f"linear ([{M}, {K}] x "
                 f"{[tuple(w.shape) for w in ws]})")
    launches += 1
    return shaped


def linear(x: torch.Tensor, w: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``: in x's type, or with ``out_dtype =
    torch.float32`` the float32 product of the bf16 values (the LM head).
    On the card both are contiguous bf16 and K and N multiples of 8."""
    return linear_group(x, [w], out_dtype)[0]
