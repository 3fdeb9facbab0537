"""Gated MLP (SwiGLU / GeGLU) blocks (mirrors ``repro.nn.mlp``)."""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from .common import ACTIVATIONS, dense_init


def init_mlp(gen: Optional[torch.Generator], d_model: int, d_ff: int,
             device: Union[str, torch.device] = "cpu") -> Dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), device=device),
        "w_up": dense_init(gen, (d_model, d_ff), device=device),
        "w_down": dense_init(gen, (d_ff, d_model), device=device),
    }


def mlp_block(p: Dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``act(x W_gate) * (x W_up) W_down`` in ``x.dtype`` (a no-op cast for
    the bf16 compute copies the serve path keeps)."""
    dt = x.dtype
    fn = ACTIVATIONS[act]
    h = fn(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)
