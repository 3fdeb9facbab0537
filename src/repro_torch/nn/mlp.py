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


def mlp_block(p: Dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``act(x W_gate) * (x W_up) W_down`` in ``x.dtype``; the products
    are the row-invariant kernel on the card, gate and up in one launch
    (``ops.linear_group``)."""
    gate, up = ops.linear_group(x, [p["w_gate"], p["w_up"]])
    h = ACTIVATIONS[act](gate) * up
    return ops.linear(h, p["w_down"])
