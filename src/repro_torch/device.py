"""Device policy of the port's entry points.

Entry points default to ``cuda``.  Without CUDA they raise unless the
caller passed ``device="cpu"``, and on a card other than sm_90 (Hopper)
they raise too, because the kernels are built for ``sm_90a``.  Nothing
carries on quietly on the CPU.
"""
from __future__ import annotations

import subprocess
from typing import List, Union

import torch

__all__ = ["resolve_device", "tensor_device", "device_count", "card_info"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The ``torch.device`` to run on, or raise if the policy forbids it."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"{torch.cuda.get_device_name(dev)} is sm_{cap[0]}"
                           f"{cap[1]}; the kernels are built for sm_90a "
                           "(Hopper)")
    return dev


def tensor_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device to allocate a model's tensors on: ``meta`` as itself
    (shapes without data, for the dry-run planner ``launch.dryrun``), any
    other through ``resolve_device``."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def device_count(device: torch.device) -> int:
    """The physical devices of ``device``'s type in this process: the
    cards on ``cuda``, 1 on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def card_info() -> List[str]:
    """The first card's ``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30).stdout
    return [field.strip() for field in out.splitlines()[0].split(",")]
