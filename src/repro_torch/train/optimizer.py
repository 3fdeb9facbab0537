"""AdamW with a cosine schedule (mirrors ``repro.train.optimizer``).

The same float32 operations in the same order as the JAX package's
``update``, on each leaf, with two differences of form: the port updates
the parameters and the moments in place (no second copy of a 1.78 B
parameter model's masters and moments), and it applies each operation to
many tensors at once (``torch._foreach_*``: a few hundred launches a
step on the card where one tensor at a time took some 6,000).  Decoupled
weight decay applies where the JAX leaf has ``ndim >= 2``
(``repro_torch.tree``): every layer tensor, the stacked norm scales and
biases included, and not ``ln_f``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..tree import leaves, map_leaves

__all__ = ["AdamWConfig", "AdamWState", "schedule", "init", "update"]


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor  # 0-dim int32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # first moment in bf16 (v stays float32: it sets the step's scale)
    m_dtype: str = "f32"  # 'f32' | 'bf16'


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` of ``lr``
    (float32, on ``step``'s device)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params, cfg: "AdamWConfig" = None) -> AdamWState:
    """Zero moments (m in bf16 with ``m_dtype="bf16"``) and count 0."""
    m_dt = torch.bfloat16 if (cfg and cfg.m_dtype == "bf16") else None

    def zeros(dtype):
        return lambda leaf: [torch.zeros(p.shape, dtype=dtype or p.dtype,
                                         device=p.device)
                             for p in leaf.parts]

    dev = leaves(params)[0].parts[0].device
    return AdamWState(m=map_leaves(zeros(m_dt), params),
                      v=map_leaves(zeros(None), params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


# elements a group of tensors updated together holds at most (its
# temporaries are five float32 copies of it), so the update's extra memory
# stays a few GB for a 1.78 B parameter model
CHUNK = 1 << 28


def _chunks(parts: List[Tuple]) -> List[List[Tuple]]:
    out, cur, n = [], [], 0
    for t in parts:
        if cur and n + t[0].numel() > CHUNK:
            out.append(cur)
            cur, n = [], 0
        cur.append(t)
        n += t[0].numel()
    return out + ([cur] if cur else [])


def _adamw(ps, gs, ms, vs, lr, b1c, b2c, wd, cfg: AdamWConfig) -> None:
    """The JAX update's operations, in its order, on lists of tensors:
    ``torch._foreach_*`` launches one kernel an operation for many tensors
    on the card, and rounds each element once an operation, as the
    per-tensor operations do (no fused multiply-add)."""
    gs = [g.to(torch.float32) for g in gs]
    m32 = torch._foreach_mul([m.to(torch.float32) for m in ms], cfg.b1)
    torch._foreach_add_(m32, torch._foreach_mul(gs, 1 - cfg.b1))
    gg = torch._foreach_mul(gs, 1 - cfg.b2)
    torch._foreach_mul_(gg, gs)
    torch._foreach_mul_(vs, cfg.b2)
    torch._foreach_add_(vs, gg)
    del gg
    den = torch._foreach_div(vs, b2c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    step = torch._foreach_div(m32, b1c)
    torch._foreach_mul_(step, lr)
    torch._foreach_div_(step, den)
    del den
    if wd is not None:  # decoupled weight decay on matrices only
        torch._foreach_add_(step, torch._foreach_mul(ps, wd))
    torch._foreach_sub_(ps, step)
    for m, x in zip(ms, m32):
        m.copy_(x)


@torch.no_grad()
def update(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step, in place; returns ``(params, state)``."""
    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = 1 - torch.pow(cfg.b1, count.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, count.to(torch.float32))
    wd = lr * cfg.weight_decay
    groups: Dict[bool, List[Tuple]] = {True: [], False: []}
    for p_leaf, g_leaf, m_leaf, v_leaf in zip(
            leaves(params), leaves(grads), leaves(state.m), leaves(state.v)):
        groups[p_leaf.ndim >= 2] += zip(p_leaf.parts, g_leaf.parts,
                                        m_leaf.parts, v_leaf.parts)
    for decay, parts in groups.items():
        for chunk in _chunks(parts):
            ps, gs, ms, vs = (list(x) for x in zip(*chunk))
            _adamw(ps, gs, ms, vs, lr, b1c, b2c, wd if decay else None, cfg)
    return params, AdamWState(m=state.m, v=state.v, count=count)
