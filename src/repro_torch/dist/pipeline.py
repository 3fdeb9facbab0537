"""GPipe-style pipeline parallelism over the transformer layers (mirrors
``repro.dist.pipeline``).

Pipelining re-cuts the layer stack into ``n_stages`` contiguous stages and
runs the classic GPipe schedule: microbatch *m* enters stage *s* at tick
``t = m + s``, so at any tick every stage works on a different microbatch
and stage *s*'s input is stage *s−1*'s output from the previous tick.
Gradients come from differentiating the full schedule (synchronous GPipe:
all microbatch gradients accumulate into one update), and the
per-microbatch loss is the same objective the unpipelined train step
optimizes — next-token CE + z-loss + MoE aux.

The port keeps the layers as a list, so a stage is a slice of it.  Every
stage runs on the mesh's one device (``dist.sharding.Mesh``): the
schedule's order of work is the JAX package's, each stage's layers are
``arch.model._layer`` (every product ``ops.linear``), and autograd
differentiates the whole schedule.  ``n_stages`` defaults to the mesh's
``pod`` axis.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..arch import model as M
from ..arch.config import ArchConfig
from ..tree import leaves, map_leaves

__all__ = ["n_pipeline_stages", "split_layers_for_stages", "staged_pspecs",
           "make_pipeline_step"]


def n_pipeline_stages(mesh, n_stages: Optional[int] = None) -> int:
    """Explicit stage count, else the mesh's pod axis (1 without pods)."""
    if n_stages is not None:
        if n_stages < 1:
            raise ValueError(f"n_stages must be >= 1, got {n_stages}")
        return int(n_stages)
    try:
        return int(dict(mesh.shape).get("pod", 1))
    except (AttributeError, TypeError):
        return 1


def split_layers_for_stages(params: Dict[str, Any], n_stages: int):
    """Re-cut the ``layers`` list into per-stage lists.

    Returns the staged tree: every non-layer entry unchanged, plus
    ``stages`` — a list of ``n_stages`` lists of ``n_layers // n_stages``
    layers each (the same tensors, not copies).
    """
    if "layers" not in params:
        raise NotImplementedError(
            "pipeline parallelism currently supports the homogeneous "
            "stacked-'layers' families (dense/moe); heterogeneous "
            "macro stacks pipeline at macro granularity in a follow-up")
    n_layers = len(params["layers"])
    if n_stages < 1 or n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers do not split into {n_stages} equal stages")
    per = n_layers // n_stages
    staged = {k: v for k, v in params.items() if k != "layers"}
    staged["stages"] = [params["layers"][i * per:(i + 1) * per]
                        for i in range(n_stages)]
    return staged


def staged_pspecs(pspecs: Dict[str, Any], n_stages: int):
    """Partition-spec tree matching ``split_layers_for_stages`` output.

    Every layer keeps its spec (the stack's leading dim, the one a stage
    slices, is never sharded), so stage *s* takes its layers' specs.
    """
    layers = pspecs["layers"]
    if n_stages < 1 or len(layers) % n_stages:
        raise ValueError(
            f"{len(layers)} layers do not split into {n_stages} equal "
            f"stages")
    per = len(layers) // n_stages
    staged = {k: v for k, v in pspecs.items() if k != "layers"}
    staged["stages"] = [layers[s * per:(s + 1) * per]
                        for s in range(n_stages)]
    return staged


def make_pipeline_step(cfg: ArchConfig, mesh, pspecs, *,
                       n_stages: Optional[int] = None, n_micro: int = 1,
                       q_block: int = 512, moe_impl: str = "dense",
                       remat: bool = False) -> Tuple[Callable, Any]:
    """Build the microbatched pipeline step.

    Returns ``(step_fn, staged_specs)`` where ``step_fn(staged_params,
    batch) -> (loss, grads)`` runs the GPipe schedule over ``n_micro``
    microbatches (``staged_params`` float32 masters as
    ``split_layers_for_stages`` gives them; ``grads`` float32, mirroring
    them) and ``staged_specs`` mirrors the staged tree.  ``remat``
    recomputes each layer in the backward.
    """
    if cfg.family in ("vlm", "encdec") or cfg.block_pattern:
        # vlm needs the patch frontend prepended / sliced, encdec needs
        # the encoder + cross-attention path, and block_pattern stacks
        # keep their layers under 'macros'/'tail' — all diverge from the
        # token-only homogeneous schedule below and would train a
        # *different* objective silently.  Refuse rather than drift.
        kind = cfg.family if not cfg.block_pattern else "hybrid/ssm"
        raise NotImplementedError(
            f"pipeline step does not support '{kind}' configs yet: their "
            "compute path is outside the staged homogeneous layer stack")
    n_stages = n_pipeline_stages(mesh, n_stages)
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by n_stages={n_stages}")
    per = cfg.n_layers // n_stages
    windows = M.layer_windows(cfg)
    stage_windows = [[int(w) for w in windows[s * per:(s + 1) * per]]
                     for s in range(n_stages)]
    specs = staged_pspecs(pspecs, n_stages)

    def run_stage(s: int, stage_masters, h_aux, pos, rope):
        h, aux = h_aux
        # each use casts the masters anew, as the JAX forward does: the
        # microbatches' cotangents meet in float32, at the masters
        stage_params = M.compute_params(stage_masters, train=True)
        for lp, window in zip(stage_params, stage_windows[s]):
            def body(x, lp=lp, window=window):
                x, a = M._layer(lp, cfg, window, pos, q_block, rope,
                                moe_impl, x)
                return x, (torch.zeros((), dtype=torch.float32,
                                       device=x.device) if a is None else a)
            h, a = (checkpoint(body, h, use_reentrant=False) if remat
                    else body(h))
            aux = aux + a
        return h, aux

    def pipeline_loss(p, tokens):
        B, S = tokens.shape
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
        mb = B // n_micro
        micros = [tokens[m * mb:(m + 1) * mb] for m in range(n_micro)]
        pos = M._positions(mb, S, tokens.device)
        rope = M._rope(cfg, pos)
        zero = torch.zeros((), dtype=torch.float32, device=tokens.device)

        # GPipe schedule: tick t runs stage s on microbatch m = t - s.
        # outs[s] is stage s's (activation, aux) from the previous tick;
        # stage s's input this tick is outs[s-1] (microbatch t-s).
        outs: list = [None] * n_stages
        losses = []
        for t in range(n_micro + n_stages - 1):
            new_outs: list = [None] * n_stages
            for s in range(n_stages):
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                h_in = ((M._embed_inputs(
                    M.compute_params({"embed": p["embed"]}, train=True),
                    cfg, {"tokens": micros[m]}), zero)
                    if s == 0 else outs[s - 1])
                new_outs[s] = run_stage(s, p["stages"][s], h_in, pos, rope)
                if s == n_stages - 1:
                    h, aux = new_outs[s]
                    head = M.compute_params({"ln_f": p["ln_f"],
                                             "head": p["head"]}, train=True)
                    logits = M.lm_head(head, h, cfg.norm_eps)
                    losses.append(M.token_ce_loss(logits, micros[m], aux))
            outs = new_outs
        return sum(losses) / n_micro

    def step_fn(staged, batch):
        masters = map_leaves(lambda leaf: [t.detach().requires_grad_(True)
                                           for t in leaf.parts], staged)
        flat = [t for leaf in leaves(masters) for t in leaf.parts]
        loss = pipeline_loss(masters, batch["tokens"])
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(gs)
        grads = map_leaves(
            lambda leaf: [torch.zeros_like(t) if g is None else g.float()
                          for t, g in zip(leaf.parts, it)], masters)
        return loss.detach(), grads

    return step_fn, specs
