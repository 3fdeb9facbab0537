"""Error-feedback int8 gradient compression (mirrors ``repro.dist.compress``).

Each gradient leaf is quantized to int8 with a per-tensor absmax scale; the
quantization residual is carried in a float32 error accumulator and added
back before the next quantization, so over K steps the accumulated
dequantized gradient equals the true sum up to one step's quantization
error.

A leaf is the JAX package's (``repro_torch.tree``): its stacked
``layers/mixer/wq`` is one ``[L, D, D]`` array with one scale over all L
layers, so here the scale is the absmax over every layer's tensor of that
name, and the bits equal the JAX package's.  The port updates the
gradients and the error accumulators in place.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..tree import leaves, map_leaves

__all__ = ["init_error_state", "compress_grads", "compression_ratio"]

_EPS = 1e-20
_QMAX = 127.0


def init_error_state(params) -> Any:
    """Zero float32 error accumulators mirroring the parameter tree."""
    return map_leaves(lambda leaf: [torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device)
                                    for p in leaf.parts], params)


@torch.no_grad()
def compress_grads(grads, err) -> Tuple[Any, Any]:
    """Quantize + dequantize every gradient leaf with error feedback, in
    place: each gradient becomes its dequantized value (float32) and each
    accumulator the new residual.  Returns ``(grads, err)``."""
    for g_leaf, e_leaf in zip(leaves(grads), leaves(err)):
        if g_leaf.key != e_leaf.key:
            raise ValueError(f"error state {e_leaf.key} for {g_leaf.key}")
        xs = [g.float() + e for g, e in zip(g_leaf.parts, e_leaf.parts)]
        amax = torch.stack([torch.amax(torch.abs(x)) for x in xs]).amax()
        scale = torch.clamp(amax / _QMAX, min=_EPS)
        for g, e, x in zip(g_leaf.parts, e_leaf.parts, xs):
            q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX).to(
                torch.int8)
            deq = q.float() * scale
            e.copy_(x - deq)
            g.copy_(deq)
    return grads, err


def compression_ratio(grads) -> float:
    """Wire-bytes ratio of float32 gradients against the int8 payload and a
    float32 scale a leaf (shape-only arithmetic)."""
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves(grads)]
    f32 = sum(s * 4 for s in sizes)
    q = sum(s * 1 + 4 for s in sizes)
    return f32 / max(q, 1)
