"""Mesh construction (mirrors ``repro.launch.mesh``) over logical chips.

The JAX package builds its meshes from ``jax.devices()``, which on the
CPU are as many fake devices as ``--xla_force_host_platform_device_count``
asks for.  The port's counterpart of that flag is ``chips``: how many
logical chips the one physical device offers (default: the physical
devices, ``torch.cuda.device_count()`` on the card, 1 on the CPU).  A mesh
takes the first chips in order, as the JAX functions take the first
devices, and every chip lives on ``device`` (``dist.sharding.Mesh``).
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..device import device_count, resolve_device
from ..dist.sharding import Mesh

__all__ = ["make_production_mesh", "make_smoke_mesh", "make_serve_mesh",
           "data_submeshes"]


def _chips(device, chips: Optional[int]):
    dev = resolve_device(device)
    return dev, (device_count(dev) if chips is None else int(chips))


def make_production_mesh(*, multi_pod: bool = False,
                         chips: Optional[int] = None,
                         device: Union[str, torch.device] = "cuda") -> Mesh:
    """The 16x16 ``(data, model)`` pod, or with ``multi_pod`` the 2x16x16
    ``(pod, data, model)`` fleet."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    dev, have = _chips(device, chips)
    if have < n:
        raise RuntimeError(
            f"mesh needs {n} devices, found {have} — pass chips={n} "
            "(logical chips on the one device, the port's counterpart of "
            "XLA_FLAGS=--xla_force_host_platform_device_count) or run on "
            "a real pod slice")
    return Mesh(np.arange(n).reshape(shape), axes, dev)


def make_smoke_mesh(data: int = 1, model: int = 1,
                    chips: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda") -> Mesh:
    """Tiny ``(data, model)`` mesh over the first ``data * model`` chips."""
    n = data * model
    dev, have = _chips(device, chips)
    if have < n:
        raise RuntimeError(f"smoke mesh {data}x{model} needs {n} devices, "
                           f"found {have} — pass chips={n}")
    return Mesh(np.arange(n).reshape(data, model), ("data", "model"), dev)


def make_serve_mesh(spec: str = "auto", chips: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda") -> Mesh:
    """Serve mesh from a ``DATAxMODEL`` spec string (e.g. ``1x8``, ``2x4``).

    ``auto`` spreads every chip over the model axis of a single data
    shard — the layout whose token streams are bit-identical to the
    single-host batcher (one shard = one schedule).
    """
    dev, have = _chips(device, chips)
    if spec == "auto":
        data, model = 1, have
    else:
        try:
            d, _, m = spec.lower().partition("x")
            data, model = int(d), int(m)
            if data < 1 or model < 1:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"mesh spec {spec!r} is not DATAxMODEL (e.g. 1x8)") from None
    n = data * model
    if have < n:
        raise RuntimeError(
            f"serve mesh {spec!r} needs {n} devices, found {have} — pass "
            f"chips={n} or shrink the mesh")
    return Mesh(np.arange(n).reshape(data, model), ("data", "model"), dev)


def data_submeshes(mesh: Mesh) -> List[Mesh]:
    """One ``("data", "model")`` mesh per data-parallel slice ("host").

    Each slice keeps its model axis and a size-1 data axis, so every
    sharding rule that names ``data`` degrades to replication.
    """
    devs = np.asarray(mesh.devices)
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(
            f"serve meshes are (data, model); got {mesh.axis_names}")
    return [Mesh(devs[i: i + 1], ("data", "model"), mesh.device)
            for i in range(devs.shape[0])]
