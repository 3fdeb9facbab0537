"""Carry the JAX package's parameters and decode state across to the port.

``params_from_arrays(np_tree, cfg, device)`` takes the numpy tree of
``jax.tree.map(np.asarray, repro.arch.model.init_params(cfg, key))`` (the
float32 masters, layers stacked on axis 0) and returns the port's compute
parameters (``arch.model``), so that both packages compute the same
function on the same inputs; ``master_params_from_arrays`` returns the
port's float32 masters instead (the trainer's, or a JAX checkpoint's
``params`` to seed it), and ``arrays_from_master_params`` turns masters
back into the JAX package's stacked numpy tree, so that updated
parameters compare leaf by leaf (an MoE layer's ``moe`` subtree keeps the
JAX layout, ``[E, D, F]`` experts, in the masters and in the numpy tree;
only its compute copy flattens them, ``nn.moe.compute_moe``);
``decode_state_from_arrays`` does the same
for a decode state (``init_decode_state``), so both can continue from one
mid-run cache or recurrent state.  A ``block_pattern`` config's ``macros``
(each entry stacked over the macros) and ``tail`` (a list of layers) cross
the same way, and its decode state keeps the JAX package's keys and
layout; so do the enc-dec family's ``enc_layers`` and ``cross_layers``
(stacked), ``enc_ln_f`` and ``frontend_proj``, and its ``cross`` planes.
Nothing here imports JAX: the caller hands over plain numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from ..device import resolve_device
from .config import ArchConfig
from .model import Params, compute_params, macro_pattern


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


def _layers(stacked: Dict, n: int, what: str, device) -> list:
    got = np.asarray(stacked["ln1"]).shape[0]
    if got != n:
        raise ValueError(f"{got} stacked {what} for {n} in the config")
    return [_tensors(l, device) for l in _unstack(stacked, n)]


def master_params_from_arrays(np_tree: Dict, cfg: ArchConfig,
                              device: Union[str, torch.device] = "cuda"
                              ) -> Params:
    """The JAX package's parameter tree (numpy, float32 masters, layers or
    macros stacked) -> the port's float32 masters on ``device``."""
    device = resolve_device(device)
    keys = ["embed", "head", "ln_f"]
    if cfg.n_encoder_layers:
        keys.append("enc_ln_f")
    if cfg.frontend:
        keys.append("frontend_proj")
    out = {k: _tensors(np_tree[k], device) for k in keys}
    if cfg.n_encoder_layers:
        out["enc_layers"] = _layers(np_tree["enc_layers"],
                                    cfg.n_encoder_layers, "enc_layers", device)
        out["cross_layers"] = _layers(np_tree["cross_layers"], cfg.n_layers,
                                      "cross_layers", device)
    if not cfg.block_pattern:
        out["layers"] = _layers(np_tree["layers"], cfg.n_layers, "layers",
                                device)
        return out
    pat, n_macro, n_tail = macro_pattern(cfg)
    out["macros"] = {k: _layers(np_tree["macros"][k], n_macro, "macros",
                                device)
                     for k in (f"m{i}_{kind}" for i, kind in enumerate(pat))}
    if len(np_tree["tail"]) != n_tail:
        raise ValueError(f"{len(np_tree['tail'])} tail layers for {n_tail} "
                         f"in the config")
    out["tail"] = [_tensors(l, device) for l in np_tree["tail"]]
    return out


def params_from_arrays(np_tree: Dict, cfg: ArchConfig,
                       device: Union[str, torch.device] = "cuda") -> Params:
    """The JAX package's parameter tree (numpy) -> the port's compute
    parameters on ``device``."""
    return compute_params(master_params_from_arrays(np_tree, cfg, device))


def arrays_from_master_params(params: Params) -> Dict:
    """The port's masters -> the JAX package's tree of numpy arrays
    (``layers``, ``enc_layers``, ``cross_layers`` and each ``macros``
    entry stacked on axis 0, ``tail`` a list), with the JAX leaves'
    dtypes."""
    def host(t):
        return t.detach().cpu().numpy()

    def stack(layers):
        first = layers[0]
        return {k: stack([l[k] for l in layers]) if isinstance(v, dict)
                else np.stack([host(l[k]) for l in layers])
                for k, v in first.items()}

    def one(t):
        return {k: one(v) for k, v in t.items()} if isinstance(t, dict) \
            else host(t)

    out = {}
    for k, v in params.items():
        if k in ("layers", "enc_layers", "cross_layers"):
            out[k] = stack(v)
        elif k == "macros":
            out[k] = {m: stack(layers) for m, layers in v.items()}
        elif k == "tail":
            out[k] = [one(l) for l in v]
        else:
            out[k] = host(v)
    return out


def _cache(a, dtype: torch.dtype, device) -> torch.Tensor:
    """One numpy cache plane -> a tensor of ``dtype`` on ``device`` (bf16
    planes come as float32 values: numpy has no bf16 of its own, and the
    values are exact in both)."""
    a = np.asarray(a)
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            device=device, dtype=dtype)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def decode_state_from_arrays(np_state: Dict, cfg: ArchConfig,
                             device: Union[str, torch.device] = "cuda"
                             ) -> Dict:
    """The JAX package's decode state as numpy arrays (``pos``, ``kv = (k,
    v)`` ``[n_layers, B, S, KV, hd]`` bf16 or int8, and for int8
    ``kv_scales``; for a ``block_pattern`` config the ``m{i}_*`` and
    ``tail{i}_*`` entries: attention rings bf16, recurrent states float32)
    -> the port's ``arch.model.init_decode_state`` layout on ``device``, so
    that both packages can continue from one mid-run state; an enc-dec
    state's ``cross = (k, v)`` planes cross as bf16."""
    device = resolve_device(device)
    if cfg.block_pattern:
        state = {"pos": torch.tensor(int(np.asarray(np_state["pos"])),
                                     dtype=torch.int32, device=device)}
        for key, val in np_state.items():
            if key == "pos":
                continue
            if key.endswith("_kv"):
                state[key] = tuple(_cache(a, torch.bfloat16, device)
                                   for a in val)
            else:
                state[key] = {k: _cache(a, torch.float32, device)
                              for k, a in val.items()}
        return state
    k, v = (np.asarray(a) for a in np_state["kv"])
    if k.ndim != 5 or k.shape[0] != cfg.n_layers or v.shape != k.shape:
        raise ValueError(f"kv planes {k.shape} / {v.shape} are not "
                         f"[{cfg.n_layers}, B, S, KV, hd]")
    int8 = "kv_scales" in np_state
    dt = torch.int8 if int8 else torch.bfloat16
    state = {"pos": torch.tensor(int(np.asarray(np_state["pos"])),
                                 dtype=torch.int32, device=device),
             "kv": (_cache(k, dt, device), _cache(v, dt, device))}
    if int8:
        state["kv_scales"] = tuple(_cache(a, torch.float32, device)
                                   for a in np_state["kv_scales"])
    if "cross" in np_state:
        state["cross"] = tuple(_cache(a, torch.bfloat16, device)
                               for a in np_state["cross"])
    return state
