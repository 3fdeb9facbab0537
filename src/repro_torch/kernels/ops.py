"""Public kernel ops with device dispatch.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel, or the call raises.  There is no other path: no
fallback from a kernel that fails to build or launch.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import bnn_mlp as _bnn_mlp
from . import bucketize as _bucketize
from . import fused_eb as _fused_eb
from . import lb_lookup as _lb_lookup
from . import linear as _linear
from . import moe as _moe
from . import paged_attention as _paged_attention
from . import ref
from . import ternary_match as _ternary_match

__all__ = ["bucketize", "ternary_match", "fused_eb_match", "lb_lookup",
           "bnn_popcount_matmul", "pack_bits", "bnn_forward",
           "paged_attention", "linear", "linear_group", "moe_down_combine",
           "launch_counts", "reset_launch_counts"]

_KERNELS = {"bucketize": _bucketize, "ternary_match": _ternary_match,
            "fused_eb": _fused_eb, "lb_lookup": _lb_lookup,
            "bnn_popcount_matmul": _bnn_mlp,
            "paged_attention": _paged_attention, "linear": _linear,
            "moe_down_combine": _moe}


def bucketize(values: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    return _bucketize.bucketize(values, thresholds)


def ternary_match(keys, values, masks, prio_action, default_action: int):
    if values.shape[0] == 0:  # all rows folded into the default action
        return torch.full((keys.shape[0],), int(default_action),
                          dtype=torch.int32, device=keys.device)
    return _ternary_match.ternary_match(keys, values, masks, prio_action,
                                        default_action)


def fused_eb_match(values, thresholds, rows_v, rows_m, prio_action, layout,
                   default_action: int, identity: bool = False):
    """Single-launch EB pipeline (encode + pack + match)."""
    if rows_v.shape[0] == 0:
        return torch.full((values.shape[0],), int(default_action),
                          dtype=torch.int32, device=values.device)
    return _fused_eb.fused_eb(values, thresholds, rows_v, rows_m, prio_action,
                              layout, default_action, identity)


def lb_lookup(x: torch.Tensor, luts: torch.Tensor, epilogue: str = "sums",
              bias: Optional[torch.Tensor] = None,
              pairs: Optional[torch.Tensor] = None, n_classes: int = 0,
              scale: float = 1.0) -> torch.Tensor:
    """LB accumulate: out[b, k] = sum_f luts[f, x[b, f], k]; with
    ``epilogue`` the whole LB predict in the same launch
    (``lb_lookup.lb_lookup``)."""
    return _lb_lookup.lb_lookup(x, luts, epilogue, bias, pairs, n_classes,
                                scale)


def bnn_popcount_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                        in_bits: int = 0, epilogue: str = "counts",
                        n_in: int = 0) -> torch.Tensor:
    """XNOR-popcount counts [B, N] of packed rows x [B, W] and w [N, W]; with
    ``in_bits`` x is the features (input prologue), with ``epilogue`` the
    layer's sign words or scores (``bnn_mlp.bnn_popcount_matmul``)."""
    return _bnn_mlp.bnn_popcount_matmul(x, w_packed, in_bits, epilogue, n_in)


def pack_bits(bits01: torch.Tensor) -> torch.Tensor:
    """0/1 [..., N] -> words [..., ceil(N/32)], LSB-first (plain torch)."""
    return ref.pack_bits_ref(bits01)


def bnn_forward(x: torch.Tensor,
                layers: Sequence[Tuple[torch.Tensor, int]],
                plain: bool = False, in_bits: int = 0) -> torch.Tensor:
    """Full DM-BNN forward per paper Eq. 8, one launch a layer.

    ``layers[i] = (w_packed [N, W], n_in)`` with ``n_in`` the true fan-in.
    Pad bits are zero in x and w, so each of the ``32*W - n_in`` pad bits
    counts as a match and is subtracted: ``dot = 2*(counts - pad) - n_in``
    is x.w over ±1 vectors.  Hidden layers apply SIGN and repack (the
    ``"sign"`` epilogue); the final layer returns the raw int32 scores.
    x is packed [B, W], or with ``in_bits`` the int32 features [B, F] that
    the first layer packs itself.  ``plain=True`` runs the plain version of
    each layer on any device.
    """
    if not layers:
        raise ValueError("bnn_forward needs at least one layer")
    layer = ref.bnn_popcount_matmul_ref if plain else bnn_popcount_matmul
    h, last = x, len(layers) - 1
    for i, (w_packed, n_in) in enumerate(layers):
        h = layer(h, w_packed, in_bits if i == 0 else 0,
                  "score" if i == last else "sign", n_in)
    return h


# attend q [B, C, H, hd] over a paged pool through its block table
paged_attention = _paged_attention.paged_attention


def linear(x: torch.Tensor, w: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` with each row's bits independent of the
    other rows (``linear.linear``); ``out_dtype=torch.float32`` for the
    LM head.  Carries a gradient where autograd records
    (``linear.linear_backward``: ``torch.matmul``)."""
    return _linear.linear(x, w, out_dtype)


def linear_group(x: torch.Tensor, ws: Sequence[torch.Tensor],
                 out_dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """``[x @ w for w in ws]`` (up to three weights) in one launch, each
    output bitwise its own ``linear(x, w)`` (``linear.linear_group``), with
    a gradient as ``linear``."""
    return _linear.linear_group(x, ws, out_dtype)


def moe_down_combine(h: torch.Tensor, w_down: torch.Tensor,
                     combine: torch.Tensor) -> torch.Tensor:
    """The MoE block's expert down product and combine, ``h [M, E, F]``,
    ``w_down [E, F, D]``, ``combine [M, E]`` bf16 -> ``[M, D]`` bf16, each
    row's bits independent of the other rows (``moe.moe_down_combine``)."""
    return _moe.moe_down_combine(h, w_down, combine)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
