"""Checks shared by the kernel wrappers before a pointer reaches CUDA."""
from __future__ import annotations

import torch


def require(t: torch.Tensor, name: str, ndim: int, device: torch.device) -> None:
    """int32, contiguous, ``ndim`` dimensions, on ``device``; else raise."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (uint32 bits as int32), "
                        f"got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on 16 bytes (a
    view at an offset), for kernels that load 8- or 16-byte vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
