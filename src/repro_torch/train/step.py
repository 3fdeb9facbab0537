"""The training step: microbatch accumulation, compression, AdamW (mirrors
``repro.train.step``).

``make_train_step(cfg, tcfg)`` returns ``train_step(params, state, batch)
-> (params, state, loss)`` over float32 masters.  Each microbatch's loss
and gradients come from ``arch.model.loss_fn`` on the step's compute
copies; the gradients are accumulated in float32, divided by the count of
microbatches, optionally compressed (``dist.compress``), and applied by
``train.optimizer.update``; then ``step + 1``.

The compute copies are tensors the step keeps from call to call, refreshed
from the masters at the start of every call: the bf16 matrices, biases and
LM head (the values of the JAX forward's ``astype(bfloat16)``), and for the
embedding and the norm scales the masters themselves.  They are the leaves
autograd differentiates, so a bf16 leaf's gradient is the bf16 cotangent
JAX converts to float32 for its master, and it is converted and added to
the float32 accumulator once a microbatch (never summed in bf16).  Keeping
them in place also keeps each bf16 weight at one address, which the
``linear`` kernel's cache of weight maps is keyed by.  The port updates
the masters, the moments and the accumulators in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..arch import model as M
from ..arch.config import ArchConfig
from ..device import tensor_device
from ..dist import compress as C
from ..tree import leaves, map_leaves
from . import optimizer as opt

__all__ = ["TrainConfig", "init_train_state", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    compress_grads: bool = False
    moe_impl: str = "dense"  # no effect on the dense family
    q_block: int = 512
    unroll: bool = False  # no effect: the port's layers are a Python loop
    mlstm_chunk: int = 0  # the mLSTM's chunk width (0: MLSTM_CHUNK)
    remat_policy: str = "full"  # 'full' | 'dots' | 'none'
    adamw: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig, seed: int = 0,
                     device="cuda"):
    """(float32 masters from ``seed``, {"opt", "step"[, "err"]})."""
    device = tensor_device(device)
    params = M.init_params(cfg, seed, device, masters=True)
    state = {"opt": opt.init(params, tcfg.adamw),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if tcfg.compress_grads:
        state["err"] = C.init_error_state(params)
    return params, state


class _Copies:
    """The step's compute copies, its float32 gradient accumulators, and
    the masters they mirror."""

    def __init__(self):
        self.masters: List[torch.Tensor] = []

    def refresh(self, params) -> None:
        parts = [p for leaf in leaves(params) for p in leaf.parts]
        if len(parts) != len(self.masters) or any(
                a is not b for a, b in zip(parts, self.masters)):
            self._build(params, parts)
        with torch.no_grad():
            for c, m in zip(self.leaf_list, self.masters):
                if c.dtype != m.dtype:
                    c.copy_(m)

    def _build(self, params, parts) -> None:
        self.masters = []  # free the old copies before making new ones
        self.compute = self.grads = self.leaf_list = self.acc_list = None
        self.keys = None

        def copy(leaf):  # a bf16 copy, or the master itself (detached)
            name = leaf.key.split("/")[-1]
            return [M.compute_params({name: p.detach()}, train=True)[name]
                    .requires_grad_(True) for p in leaf.parts]

        self.compute = map_leaves(copy, params)
        self.leaf_list = [p for leaf in leaves(self.compute)
                          for p in leaf.parts]
        self.keys = [leaf.key for leaf in leaves(self.compute)
                     for _ in leaf.parts]
        self.grads = map_leaves(
            lambda leaf: [torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device) for p in leaf.parts],
            params)
        self.acc_list = [g for leaf in leaves(self.grads) for g in leaf.parts]
        self.masters = parts


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(params, state, batch) -> (params, state,
    loss)``.  ``batch["tokens"]`` is ``[B, S]`` on the masters' device,
    ``B`` a multiple of ``tcfg.microbatches``; every other entry (a VLM's
    ``patches``, an enc-dec model's ``frames``) splits with the tokens;
    ``loss`` is the mean of the microbatches' losses, a 0-dim float32
    tensor."""
    copies = _Copies()

    def loss_of(mb: Dict[str, torch.Tensor]) -> torch.Tensor:
        return M.loss_fn(copies.compute, mb, cfg, moe_impl=tcfg.moe_impl,
                         q_block=tcfg.q_block, unroll=tcfg.unroll,
                         mlstm_chunk=tcfg.mlstm_chunk,
                         remat_policy=tcfg.remat_policy)

    def train_step(params, state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]) -> Tuple[Any, Dict, Any]:
        copies.refresh(params)
        n_micro = tcfg.microbatches
        B = batch["tokens"].shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             f"microbatches")
        size = B // n_micro
        with torch.no_grad():
            torch._foreach_zero_(copies.acc_list)
        loss = None
        for i in range(n_micro):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            mb_loss = loss_of(mb)
            gs = torch.autograd.grad(mb_loss, copies.leaf_list,
                                     allow_unused=True)
            with torch.no_grad():
                for a, g, key in zip(copies.acc_list, gs, copies.keys):
                    if g is not None:
                        a.add_(g)
                    elif not M.unread(key):
                        raise RuntimeError(f"{key}: no gradient reaches it")
            mb_loss = mb_loss.detach()
            loss = mb_loss if loss is None else loss + mb_loss
        grads = copies.grads
        if n_micro > 1:
            with torch.no_grad():
                torch._foreach_div_(copies.acc_list, n_micro)
            loss = loss / n_micro

        new_state = dict(state)
        if tcfg.compress_grads:
            grads, new_state["err"] = C.compress_grads(grads, state["err"])
        params, new_state["opt"] = opt.update(params, grads, state["opt"],
                                              tcfg.adamw)
        new_state["step"] = state["step"] + 1
        return params, new_state, loss

    return train_step
