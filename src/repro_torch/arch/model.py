"""The dense decoder's paged serve path (mirrors ``repro.arch.model``).

Ported here: ``layer_windows``, ``init_params``, ``init_paged_kv``,
``paged_decode_step`` (with ``all_positions``) and ``lm_head``, for the
dense family.  The JAX package scans stacked layers with ``lax.scan``;
here the layers are a list walked by a Python loop, and each layer writes
its slice of the ``[n_layers, N, page, KV, hd]`` pools in place.

Parameters are kept as the compute copies the JAX forward makes at each
use: matrices, biases, the embedding and the LM head in bf16 (the JAX
forward's ``astype(bfloat16)`` of its float32 masters, done once at load)
and norm scales in float32.  Every product of a step is ``ops.linear``,
or ``ops.linear_group`` for q/k/v and gate/up (the row-invariant kernel
on the card, one launch a group); the head's is the JAX head's bf16
x bf16 einsum with float32 accumulation (``preferred_element_type=
float32``): the logits are never rounded to bf16.

Not ported yet (ROADMAP queue A items 2, 8 and 9): the dense ring cache
(``init_decode_state``, ``decode_step``), the training forward, and the
MoE, recurrent, enc-dec and VLM families.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..nn import attention as A
from ..nn.attn_backend import PagedKV
from ..nn.common import dense_init, embed_init, rms_norm, rope_cos_sin
from ..nn.mlp import init_mlp, mlp_block
from .config import ArchConfig

Params = Dict[str, Any]
COMPUTE_DTYPE = torch.bfloat16

__all__ = ["COMPUTE_DTYPE", "layer_windows", "init_params", "compute_params",
           "init_paged_kv", "paged_decode_step", "lm_head"]


def check_dense(cfg: ArchConfig) -> None:
    """The port runs the dense family only (ROADMAP queue A, item 9)."""
    if cfg.block_pattern or cfg.family == "encdec" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported: the port runs dense "
            "attention stacks; MoE, recurrent, enc-dec and VLM families are "
            "ROADMAP queue A item 9")


def layer_windows(cfg: ArchConfig, n: Optional[int] = None) -> np.ndarray:
    """Per-layer attention window (0 = global)."""
    n = n or cfg.n_layers
    if cfg.global_every:
        return np.array(
            [0 if (l + 1) % cfg.global_every == 0 else cfg.local_window
             for l in range(n)], np.int32)
    return np.full(n, cfg.local_window, np.int32)


# ------------------------------------------------------------------ init
def _init_layer(gen, cfg: ArchConfig, device) -> Params:
    mixer = A.init_attention(gen, cfg.d_model, cfg.q_heads, cfg.n_kv_heads,
                             cfg.head_dim_, cfg.qkv_bias, cfg.qk_norm,
                             device=device)
    if cfg.q_heads != cfg.n_heads:  # zero pad heads: exactness
        cut = cfg.n_heads * cfg.head_dim_
        mixer["wq"][:, cut:] = 0.0
        mixer["wo"][cut:, :] = 0.0
    zeros = torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
    p: Params = {"mixer": mixer, "ln1": zeros.clone()}
    if cfg.d_ff > 0:
        p["ln2"] = zeros.clone()
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, device=device)
    return p


def init_params(cfg: ArchConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Params:
    """Random-init compute parameters from a seeded ``torch.Generator`` on
    ``device`` (normal / sqrt(fan_in), as the JAX package's init; the
    numbers differ from ``jax.random``'s).  One layer's float32 masters
    exist at a time."""
    check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    Vp, D = cfg.vocab_padded, cfg.d_model
    params: Params = {
        "embed": _compute("embed", embed_init(gen, (Vp, D), device=dev)),
        "head": _compute("head", dense_init(gen, (D, Vp), device=dev)),
        "ln_f": torch.zeros((D,), dtype=torch.float32, device=dev),
        "layers": [compute_params(_init_layer(gen, cfg, dev))
                   for _ in range(cfg.n_layers)],
    }
    return params


def _compute(name: str, t: torch.Tensor) -> torch.Tensor:
    """One float32 master -> its compute copy (see the module docstring)."""
    if name.startswith("ln") or name.endswith("_norm"):
        return t.float()
    return t.to(COMPUTE_DTYPE)


def compute_params(tree):
    """A (sub)tree of float32 masters -> the compute copies, by name."""
    if isinstance(tree, list):
        return [compute_params(x) for x in tree]
    return {k: compute_params(v) if isinstance(v, (dict, list))
            else _compute(k, v) for k, v in tree.items()}


def init_paged_kv(cfg: ArchConfig, n_pages: int, page_size: int,
                  kv_dtype: str = "bf16",
                  device: Union[str, torch.device] = "cuda") -> PagedKV:
    """The physical page pool, ``[n_layers, n_pages, page, KV, hd]`` bf16,
    or int8 with float32 scale planes ``[..., KV, 1]``, zero-filled."""
    check_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim_)
    if kv_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return PagedKV(
            *(torch.zeros(s, dtype=dt, device=device)
              for s, dt in ((shape, torch.int8), (shape, torch.int8),
                            (sshape, torch.float32), (sshape, torch.float32))))
    if kv_dtype != "bf16":
        raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")
    return PagedKV(k=torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
                   v=torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device))


# --------------------------------------------------------------- forward
def _ffn(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.d_ff == 0:
        return x
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_block(p["mlp"], h, cfg.act)


def lm_head(params: Params, x: torch.Tensor, norm_eps: float) -> torch.Tensor:
    """Final norm + vocab projection, float32 logits."""
    x = rms_norm(x, params["ln_f"], norm_eps)
    return ops.linear(x, params["head"], out_dtype=torch.float32)


def paged_decode_step(params: Params, kv: PagedKV, block_tbl: torch.Tensor,
                      pos: torch.Tensor, tokens: torch.Tensor,
                      n_new: torch.Tensor, cfg: ArchConfig, *,
                      sample_greedy: bool = False, attn_impl: str = "auto",
                      all_positions: bool = False):
    """Chunked multi-token decode/prefill through the paged KV cache.

    ``tokens [B, C]`` carries up to ``C`` new tokens per slot (``n_new[b]``
    valid, left-aligned), slot ``b`` at absolute offset ``pos[b]``;
    ``block_tbl [B, n_ps]`` maps its logical pages to physical ones.
    Returns ``(logits [B, Vp] float32 at each slot's last valid position,
    kv)`` (greedy tokens ``[B]`` int32 with ``sample_greedy``; every
    position, ``[B, C(, Vp)]``, with ``all_positions``).  ``kv`` is the
    pool-level :class:`PagedKV` of ``init_paged_kv``; it is written in
    place and returned.  ``n_new[b] = 0`` marks an idle slot: its writes
    drop and its row is garbage, never read.
    """
    if not isinstance(kv, PagedKV):
        raise TypeError(f"paged_decode_step expects the PagedKV from "
                        f"init_paged_kv, got {type(kv)}")
    check_dense(cfg)
    kv = kv.pool()
    dev = tokens.device
    B, C = tokens.shape
    N_pages, page = kv.k.shape[1], kv.k.shape[2]
    n_ps = block_tbl.shape[1]
    block_tbl = block_tbl.to(torch.int32).contiguous()
    steps = torch.arange(C, dtype=torch.int32, device=dev)
    positions = (pos.to(torch.int32)[:, None] + steps[None]).contiguous()
    valid = steps[None] < n_new.to(torch.int32)[:, None]
    lp = torch.clamp(positions // page, 0, n_ps - 1)
    page_ids = torch.gather(block_tbl, 1, lp.long())
    page_ids = torch.where(valid, page_ids, torch.full_like(page_ids, N_pages))
    page_off = positions % page
    rows = A.write_rows(page_ids, page_off, N_pages, page)  # every layer
    rope = (rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)
            if cfg.rope_theta > 0 else None)
    x = params["embed"][tokens.long()]
    windows = layer_windows(cfg)
    layers: List[Params] = params["layers"]
    for i, lp_i in enumerate(layers):
        h = rms_norm(x, lp_i["ln1"], cfg.norm_eps)
        out, _ = A.paged_decode_attention_block(
            lp_i["mixer"], h,
            kv.layer(i).with_view(block_tbl, positions, page_ids, page_off,
                                  rows),
            n_heads=cfg.q_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim_, window=int(windows[i]),
            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps, rope=rope,
            impl=attn_impl)
        x = x + out
        x = _ffn(lp_i, cfg, x)
    if all_positions:
        logits = lm_head(params, x, cfg.norm_eps)  # [B, C, Vp]
    else:
        # each slot's last valid position only, before the vocab
        # projection (rms_norm and the head are per position)
        last = torch.clamp(n_new.long() - 1, 0, C - 1)
        x = x[torch.arange(B, device=dev), last][:, None]
        logits = lm_head(params, x, cfg.norm_eps)[:, 0]
    if sample_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32), kv
    return logits, kv
