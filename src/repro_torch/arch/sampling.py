"""Token sampling: temperature / top-k / top-p with counter-based
per-request noise (mirrors ``repro.arch.sampling``).

The noise is a stateless integer hash of ``(seed, token_index, salt,
vocab_id)`` (chained murmur3 fmix32 rounds) feeding a Gumbel-max draw over
the filtered logits, so a request's token at generated index ``g`` depends
only on its seed, ``g`` and the logits.  torch has no uint32 arithmetic on
every device, so the hash runs in int64 and masks to 32 bits after every
multiply (the low 32 bits of a product do not depend on the bits above
them; each multiply takes the constant in 16-bit halves, so no int64
product overflows): its bits equal the JAX package's uint32 hash.

``temperature == 0`` is exact greedy ``argmax`` (first index on ties).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["hash_u32", "uniform", "gumbel", "filter_logits", "token_probs",
           "sample_tokens", "categorical"]

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _u32(x, device=None):
    """Any int (tensor or python, any sign) -> its uint32 bits, in int64
    for a tensor and as a python int for a python int (no host-to-device
    copy, which would make the host wait inside a serve step)."""
    if isinstance(x, (int, np.integer)):
        return int(x) & _MASK
    t = torch.as_tensor(x, device=device)
    if t.dtype.is_floating_point:
        raise TypeError(f"hash inputs are integers, got {t.dtype}")
    return t.to(torch.int64) & _MASK


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for uint32 bits ``x`` held in int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on uint32 bits held in int64."""
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_u32(seed, pos, salt=0, lane=0) -> torch.Tensor:
    """Counter-based hash of (seed, pos, salt, lane) -> uint32 bits as
    int64 in [0, 2^32).  All inputs broadcast."""
    dev = next((t.device for t in (seed, pos, salt, lane)
                if isinstance(t, torch.Tensor)), None)
    h = _mix(_u32(seed, dev) ^ _GOLDEN)
    h = _mix(h ^ _u32(pos, dev) ^ _GOLDEN)
    h = _mix(h ^ _u32(salt, dev) ^ _GOLDEN)
    return torch.as_tensor(_mix(h ^ _u32(lane, dev)), device=dev)


def uniform(seed, pos, salt=0, lane=0) -> torch.Tensor:
    """float32 uniform in [0, 1) from the top 24 hash bits (exact)."""
    return (hash_u32(seed, pos, salt, lane) >> 8).to(torch.float32) * (
        1.0 / (1 << 24))


def gumbel(seed, pos, salt=0, lane=0) -> torch.Tensor:
    """Standard Gumbel noise; the 2^-25 offset keeps log() finite at 0."""
    u = uniform(seed, pos, salt, lane) + 2.0 ** -25
    return -torch.log(-torch.log(u))


def filter_logits(logits: torch.Tensor, top_k: int,
                  top_p: float) -> torch.Tensor:
    """Mask logits outside the top-k / nucleus (top-p) set to -inf
    (top-k first, then top-p over what survives)."""
    x = logits.float()
    neg = torch.full((), float("-inf"), dtype=torch.float32, device=x.device)
    V = x.shape[-1]
    if top_k and top_k < V:
        kth = torch.sort(x, dim=-1).values[..., V - top_k, None]
        x = torch.where(x >= kth, x, neg)
    if top_p < 1.0:
        srt = torch.flip(torch.sort(x, dim=-1).values, dims=(-1,))
        p = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(p, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p
        keep = cum - p < torch.tensor(top_p, dtype=torch.float32)
        cutoff = torch.amax(torch.where(keep, srt, neg), dim=-1, keepdim=True)
        x = torch.where(x >= cutoff, x, neg)
    return x


def token_probs(logits: torch.Tensor, temperature: float, top_k: int,
                top_p: float) -> torch.Tensor:
    """Filtered softmax probabilities [..., V] float32 (temperature > 0)."""
    x = filter_logits(logits, top_k, top_p) / float(temperature)
    return torch.softmax(x, dim=-1)


def sample_tokens(logits: torch.Tensor, seed, pos, temperature: float,
                  top_k: int = 0, top_p: float = 1.0,
                  salt: int = 0) -> torch.Tensor:
    """One token per row of ``logits [..., V]``; ``seed``/``pos`` give one
    (request seed, generated-token index) pair per row."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = filter_logits(logits, top_k, top_p) / float(temperature)
    dev = x.device
    lanes = torch.arange(x.shape[-1], dtype=torch.int64, device=dev)
    seed = torch.as_tensor(seed, device=dev)[..., None]
    pos = torch.as_tensor(pos, device=dev)[..., None]
    g = gumbel(seed, pos, salt, lanes)
    return torch.argmax(x + g, dim=-1).to(torch.int32)


def categorical(probs: torch.Tensor, seed, pos, salt: int = 0) -> torch.Tensor:
    """Gumbel-max draw from explicit probabilities ``[..., V]`` (a zero is
    never drawn: log 0 = -inf).  The speculative resample draws from a
    masked p without renormalizing: Gumbel-max does not depend on the
    scale."""
    x = torch.log(probs.float())
    dev = x.device
    lanes = torch.arange(x.shape[-1], dtype=torch.int64, device=dev)
    seed = torch.as_tensor(seed, device=dev)[..., None]
    pos = torch.as_tensor(pos, device=dev)[..., None]
    g = gumbel(seed, pos, salt, lanes)
    return torch.argmax(x + g, dim=-1).to(torch.int32)
