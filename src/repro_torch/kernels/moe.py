"""CUDA kernel: the MoE block's expert down product and combine, one launch.

``out[m] = bf16(sum_e bf16(h[m, e] @ W_down[e]) * combine[m, e])``, JAX's
``"bsef,efd->bsed"`` rounded to bf16, then ``"bsed,bse->bsd"`` with float32
accumulation (``src/repro/nn/moe.py:73-75``), each sum in the order the
plain version (``ref.moe_down_combine_ref``) fixes: F ascending, then the
experts ascending.

Replaces no Pallas kernel: the JAX package leaves both einsums to XLA.  The
port runs its own because its invariants (chunked prefill equal to
token-by-token) need each row's bits to depend on that row alone, which
cuBLAS does not promise.

Bound on the H100 by bytes: a step's rows pick nearly every expert, so the
launch reads all of ``W_down`` (369 MB a qwen2-moe layer).  Design
(``csrc/moe.cu``): a block a (128-column tile, expert) computes the rows
that picked that expert, on the CUDA cores (an IEEE float32 chain, so the
plain version is matched bit for bit), into an ``[M, E, D]`` bf16 scratch;
the last block of a column tile adds the tile's rows over their experts in
ascending order.  An expert whose combine weight is 0 adds nothing, which
is the plain version's bits for every finite product (ROADMAP C.10).
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import stream_ptr
from .ref import moe_down_combine_ref

__all__ = ["moe_down_combine", "moe_down_combine_bytes"]

launches = 0  # kernel launches; the main-path check reads and resets it

TD = 128  # columns a block (kTD in the CUDA source)
FC = 32  # F rows a stage (kFC)


def moe_down_combine_bytes(h: torch.Tensor, w_down: torch.Tensor,
                           combine: torch.Tensor) -> int:
    """The least device-memory bytes of one call on these inputs: the
    ``h`` rows and ``W_down`` slices of the (row, expert) pairs with a
    nonzero weight read once, ``combine`` read once, ``out`` written once
    (bf16)."""
    pick = combine != 0
    F, D = w_down.shape[1], w_down.shape[2]
    n_pairs = int(pick.sum())
    n_experts = int(pick.any(0).sum())
    M, E = combine.shape
    return 2 * (n_pairs * F + n_experts * F * D + M * E + M * D)


def _check(h: torch.Tensor, w_down: torch.Tensor,
           combine: torch.Tensor) -> None:
    for name, t in (("h", h), ("w_down", w_down), ("combine", combine)):
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bf16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes")
    if h.dim() != 3 or w_down.dim() != 3 or combine.dim() != 2:
        raise ValueError(f"shapes: h {tuple(h.shape)} (want [M, E, F]), "
                         f"w_down {tuple(w_down.shape)} ([E, F, D]), "
                         f"combine {tuple(combine.shape)} ([M, E])")
    M, E, F = h.shape
    if w_down.shape[:2] != (E, F) or combine.shape != (M, E):
        raise ValueError(f"shapes: h {tuple(h.shape)}, w_down "
                         f"{tuple(w_down.shape)}, combine "
                         f"{tuple(combine.shape)}")
    D = w_down.shape[2]
    if F % FC or D % 8:
        raise ValueError(f"the kernel takes F a multiple of {FC} and D of 8, "
                         f"got F = {F}, D = {D}")


def moe_down_combine(h: torch.Tensor, w_down: torch.Tensor,
                     combine: torch.Tensor) -> torch.Tensor:
    """``h [M, E, F]``, ``w_down [E, F, D]``, ``combine [M, E]`` bf16 ->
    ``[M, D]`` bf16: the kernel for CUDA tensors (one launch), the plain
    version for CPU tensors."""
    global launches
    if h.device.type == "cpu":
        return moe_down_combine_ref(h, w_down, combine)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, w_down, combine)):
        raise NotImplementedError(
            "moe_down_combine carries no gradient on the card: MoE training "
            "on the card is ROADMAP queue A item 9")
    _check(h, w_down, combine)
    M, E, F = h.shape
    D = w_down.shape[2]
    out = torch.empty((M, D), dtype=torch.bfloat16, device=h.device)
    if M == 0:
        return out
    ys = torch.empty((M, E, D), dtype=torch.bfloat16, device=h.device)
    counters = torch.zeros(-(-D // TD), dtype=torch.int32, device=h.device)
    lib = _build.load("moe")
    err = lib.moe_down_combine(h.data_ptr(), w_down.data_ptr(),
                               combine.data_ptr(), ys.data_ptr(),
                               counters.data_ptr(), out.data_ptr(), M, E, F,
                               D, stream_ptr(h.device))
    _build.check(lib, err, f"moe_down_combine (h {tuple(h.shape)}, w_down "
                 f"{tuple(w_down.shape)})")
    launches += 1
    return out
