"""Gated MLP (SwiGLU / GeGLU) blocks (mirrors ``repro.nn.mlp``)."""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..kernels import ops
from .common import ACTIVATIONS, dense_init


def init_mlp(gen: Optional[torch.Generator], d_model: int, d_ff: int,
             device: Union[str, torch.device] = "cpu") -> Dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), device=device),
        "w_up": dense_init(gen, (d_model, d_ff), device=device),
        "w_down": dense_init(gen, (d_ff, d_model), device=device),
    }


def mlp_block(p: Dict, x: torch.Tensor, act: str = "silu",
              tp=None) -> torch.Tensor:
    """``act(x W_gate) * (x W_up) W_down`` in ``x.dtype``; the products
    are the row-invariant kernel on the card, gate and up in one launch
    (``ops.linear_group``).  With ``tp`` (a ``dist.sharding.
    TensorParallel``) ``p`` holds this rank's ``d_ff`` slice: gate/up are
    column slices planned as the whole weights, and ``w_down``'s row slice
    gives a float32 partial that ``tp.join`` adds over the ranks in rank
    order and rounds once."""
    if tp is None:
        gate, up = ops.linear_group(x, [p["w_gate"], p["w_up"]])
        return ops.linear(ACTIVATIONS[act](gate) * up, p["w_down"])
    gate, up = ops.linear_group(x, [p["w_gate"], p["w_up"]],
                                plan_n=p["w_gate"].shape[1] * tp.m)
    h = ACTIVATIONS[act](gate) * up
    return tp.join(ops.linear(h, p["w_down"], out_dtype=torch.float32),
                   x.dtype)
