"""Shared NN primitives: norms, RoPE, initializers, activations.

Mirrors ``repro.nn.common``.  Norms and RoPE compute in float32 and cast
back to the input's type, as the JAX package does.  Parameters are plain
dicts of tensors; the serve path keeps bf16 compute copies of the
matrices (``arch.convert``), which hold the values the JAX forward gets
from its per-use ``astype(bfloat16)``.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F


ROW_SUM_WIDTH = 32  # elements a stage of ``row_sum`` adds


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (kept, as length 1), in an order set by its
    length alone: stages of ``ROW_SUM_WIDTH`` neighbours (zero-padded; a
    zero adds exactly), until one group is left.  A plain ``sum(-1)`` on
    the card picks how many threads share a row from the number of rows
    (PyTorch's reduction config), so a row's bits change with the batch;
    a reduction over at most 32 elements is one warp's fixed tree whatever
    the rows (ROADMAP C.11)."""
    while x.shape[-1] > ROW_SUM_WIDTH:
        pad = -x.shape[-1] % ROW_SUM_WIDTH
        if pad:
            x = F.pad(x, (0, pad))
        x = x.reshape(*x.shape[:-1], -1, ROW_SUM_WIDTH).sum(-1)
    return x.sum(-1, keepdim=True)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in float32, the mean
    a ``row_sum`` (each row's bits independent of the other rows)."""
    dt = x.dtype
    x = x.float()
    var = row_sum(x * x) / x.shape[-1]
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def rope_freqs(head_dim: int, theta: float,
               device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # ``full``, not ``tensor``: no host-to-device copy inside a serve step
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) ``[..., S, 1, hd/2]`` float32 of the RoPE angles at
    ``positions [..., S]``, which ``apply_rope`` rotates by: a step
    computes them once for every layer and for both q and k."""
    freqs = rope_freqs(head_dim, theta, positions.device)  # [hd/2]
    angles = positions[..., None].float() * freqs  # [..., S, hd/2]
    angles = angles[..., None, :]  # [..., S, 1, hd/2] broadcast over heads
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos_sin) -> torch.Tensor:
    """x [..., S, H, hd] rotated by ``cos_sin = rope_cos_sin(positions,
    hd, theta)`` (positions [..., S], broadcastable)."""
    cos, sin = cos_sin
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: Optional[torch.Generator], shape, in_axis: int = 0,
               device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Normal / sqrt(fan_in), float32, from a seeded ``torch.Generator``
    on ``device``.  The numbers differ from ``jax.random``'s: weights that
    must equal the JAX package's come through ``arch.convert``."""
    t = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return t / np.sqrt(shape[in_axis])


def embed_init(gen: Optional[torch.Generator], shape,
               device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": gelu, "relu": F.relu}
