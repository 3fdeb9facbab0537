"""Public EB ops with device dispatch.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel, or the call raises.  There is no other path: no
fallback from a kernel that fails to build or launch.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import bucketize as _bucketize
from . import fused_eb as _fused_eb
from . import ternary_match as _ternary_match

__all__ = ["bucketize", "ternary_match", "fused_eb_match", "launch_counts",
           "reset_launch_counts"]

_KERNELS = {"bucketize": _bucketize, "ternary_match": _ternary_match,
            "fused_eb": _fused_eb}


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


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
