"""Carry the JAX package's parameters across to the port.

``params_from_arrays(np_tree, cfg, device)`` takes the numpy tree of
``jax.tree.map(np.asarray, repro.arch.model.init_params(cfg, key))`` (the
float32 masters, layers stacked on axis 0) and returns the port's compute
parameters (``arch.model``), so that both packages compute the same
function on the same inputs.  Nothing here imports JAX: the caller hands
over plain numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from ..device import resolve_device
from .config import ArchConfig
from .model import Params, check_dense, compute_params


def _tensors(tree, device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _unstack(tree: Dict, n: int) -> list:
    """A dict of ``[n, ...]`` arrays -> a list of n dicts of ``[...]``."""
    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return [pick(tree, i) for i in range(n)]


def params_from_arrays(np_tree: Dict, cfg: ArchConfig,
                       device: Union[str, torch.device] = "cuda") -> Params:
    """The JAX package's dense-family parameter tree (numpy) -> the port's
    compute parameters on ``device``."""
    check_dense(cfg)
    device = resolve_device(device)
    layers = np_tree["layers"]
    n = np.asarray(layers["ln1"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"{n} stacked layers for a {cfg.n_layers}-layer "
                         f"config")
    tree = {"embed": np_tree["embed"], "head": np_tree["head"],
            "ln_f": np_tree["ln_f"], "layers": _unstack(layers, n)}
    return compute_params({k: [_tensors(l, device) for l in v]
                           if k == "layers" else _tensors(v, device)
                           for k, v in tree.items()})
