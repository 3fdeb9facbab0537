"""The dense decoder: its training forward and its serve paths (mirrors
``repro.arch.model``).

Ported here, for the dense family: ``layer_windows``, ``init_params``
(float32 masters with ``masters=True``), ``forward``, ``lm_head``,
``token_ce_loss`` and ``loss_fn`` (training), ``init_paged_kv`` and
``paged_decode_step`` (with ``all_positions``), ``init_decode_state`` and
``decode_step`` (the dense ring cache).  The JAX package scans stacked
layers with ``lax.scan``; here the layers are a list walked by a Python
loop (``repro_torch.tree`` gives the JAX package's stacked view where a
rule needs it), and each layer writes its slice of the ``[n_layers, N,
page, KV, hd]`` pools, or of the ``[n_layers, B, S, KV, hd]`` ring cache,
in place.

Parameters: the trainer keeps float32 masters; the forward computes on
the copies the JAX forward makes at each use (``compute_params``):
matrices, biases and the LM head in bf16 (its ``astype(bfloat16)``),
norm scales in float32, and the embedding in bf16 for serving or, for
training, float32 (JAX gathers rows of the float32 master and then casts,
so the embedding's gradient is scatter-added in float32).  A serve engine
holds the compute copies only, made once at load.  Every product is
``ops.linear``, or ``ops.linear_group`` for q/k/v and gate/up (the
row-invariant kernel on the card, one launch a group, with a gradient in
training); the head's is the JAX head's bf16 x bf16 einsum with float32
accumulation (``preferred_element_type=float32``): the logits are never
rounded to bf16.

The MoE family (``n_experts``) runs through the same paths: a layer's
``moe`` subtree (``nn.moe``; float32 masters in the JAX layout, the serve
copy with the experts' gate and up flattened to ``[D, E * F]``) takes the
place of its ``mlp``, ``_ffn`` runs ``nn.moe.moe_block`` (the JAX
package's default dense dispatch; ``moe_impl="sparse"`` its capacity
dispatch, in plain torch), and ``forward`` returns the summed aux loss as
the JAX forward does.  The serve steps discard the aux loss, as the JAX
package's do, and do not compute it.

Not ported yet (ROADMAP queue A item 9): the recurrent, enc-dec and VLM
families, and MoE training on the card (``ops.moe_down_combine`` carries
no gradient there).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops
from ..nn import attention as A
from ..nn.attn_backend import PagedKV
from ..nn.common import dense_init, embed_init, rms_norm, rope_cos_sin
from ..nn.mlp import init_mlp, mlp_block
from ..nn.moe import compute_moe, init_moe, moe_block, moe_block_sparse
from .config import ArchConfig

Params = Dict[str, Any]
COMPUTE_DTYPE = torch.bfloat16
MOE_AUX_WEIGHT = 0.01
REMAT_POLICIES = ("full", "none")  # "dots": ROADMAP queue A item 13

__all__ = ["COMPUTE_DTYPE", "layer_windows", "init_params", "compute_params",
           "forward", "lm_head", "token_ce_loss", "loss_fn", "init_paged_kv",
           "paged_decode_step", "init_decode_state", "decode_step"]


def check_dense(cfg: ArchConfig) -> None:
    """The port runs attention stacks with an MLP or MoE feed-forward: the
    dense and MoE families (ROADMAP queue A, item 9)."""
    if cfg.block_pattern or cfg.family == "encdec" or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported: the port runs dense "
            "and MoE attention stacks; recurrent, enc-dec and VLM families "
            "are ROADMAP queue A item 9")


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
        if cfg.n_experts:
            p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff,
                                cfg.n_experts_padded, cfg.n_shared_experts,
                                cfg.shared_d_ff, device=device)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, device=device)
    return p


def init_params(cfg: ArchConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda",
                masters: bool = False) -> Params:
    """Random-init parameters from a seeded ``torch.Generator`` on
    ``device`` (normal / sqrt(fan_in), as the JAX package's init; the
    numbers differ from ``jax.random``'s): the compute copies, one layer's
    float32 masters existing at a time, or with ``masters=True`` the
    float32 masters themselves (``compute_params`` of them is the same
    compute tree)."""
    check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    conv = (lambda t: t) if masters else compute_params
    Vp, D = cfg.vocab_padded, cfg.d_model
    params: Params = conv({
        "embed": embed_init(gen, (Vp, D), device=dev),
        "head": dense_init(gen, (D, Vp), device=dev),
        "ln_f": torch.zeros((D,), dtype=torch.float32, device=dev),
    })
    params["layers"] = [conv(_init_layer(gen, cfg, dev))
                        for _ in range(cfg.n_layers)]
    return params


def _compute(name: str, t: torch.Tensor, train: bool) -> torch.Tensor:
    """One float32 master -> its compute copy (see the module docstring)."""
    if name.startswith("ln") or name.endswith("_norm") or (
            train and name == "embed"):
        return t.float()
    return t.to(COMPUTE_DTYPE)


def compute_params(tree, train: bool = False):
    """A (sub)tree of float32 masters -> the compute copies, by name; with
    ``train`` the embedding stays float32.  The casts carry a gradient, and
    a tree of compute copies maps to itself."""
    if isinstance(tree, list):
        return [compute_params(x, train) for x in tree]
    return {k: compute_moe(v) if k == "moe"
            else compute_params(v, train) if isinstance(v, (dict, list))
            else _compute(k, v, train) for k, v in tree.items()}


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


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      kv_dtype: str = "bf16",
                      device: Union[str, torch.device] = "cuda") -> Params:
    """The dense decode state: ``pos``, one global position (a 0-dim int32
    tensor on the device, advanced in place by ``decode_step``), and the
    ring cache ``kv = (k, v)``, ``[n_layers, batch, cache_len, KV, hd]``
    bf16, or int8 with ``kv_scales`` float32 ``[..., KV, 1]``, zero-filled."""
    check_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim_)
    state: Params = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if kv_dtype == "int8":
        sshape = shape[:-1] + (1,)
        state["kv"] = tuple(torch.zeros(shape, dtype=torch.int8,
                                        device=device) for _ in range(2))
        state["kv_scales"] = tuple(torch.zeros(sshape, dtype=torch.float32,
                                               device=device) for _ in range(2))
        return state
    if kv_dtype != "bf16":
        raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")
    state["kv"] = tuple(torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)
                        for _ in range(2))
    return state


# --------------------------------------------------------------- forward
def _ffn(p: Params, cfg: ArchConfig, x: torch.Tensor,
         moe_impl: str = "dense", with_aux: bool = False):
    """``(x + the layer's MLP or MoE block, its aux loss)``: the aux loss
    is a 0-dim float32 tensor for MoE with ``with_aux``, else None."""
    if cfg.d_ff == 0:
        return x, None
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        if moe_impl == "sparse":
            out, aux = moe_block_sparse(p["moe"], h, n_experts=cfg.n_experts,
                                        top_k=cfg.n_experts_active,
                                        act=cfg.act)
        else:
            out, aux = moe_block(p["moe"], h, n_experts=cfg.n_experts,
                                 top_k=cfg.n_experts_active, act=cfg.act,
                                 with_aux=with_aux)
        return x + out, aux
    return x + mlp_block(p["mlp"], h, cfg.act), None


def lm_head(params: Params, x: torch.Tensor, norm_eps: float) -> torch.Tensor:
    """Final norm + vocab projection, float32 logits."""
    x = rms_norm(x, params["ln_f"], norm_eps)
    return ops.linear(x, params["head"], out_dtype=torch.float32)


def _layer(lp: Params, cfg: ArchConfig, window: int, positions, q_block: int,
           rope, moe_impl: str, x: torch.Tensor):
    """One attention layer and its MLP or MoE block over the whole
    sequence: (x, the layer's aux loss, None for an MLP)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + A.attention_block(
        lp["mixer"], h, n_heads=cfg.q_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta, window=window,
        qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps, positions=positions,
        q_block=q_block, rope=rope)
    return _ffn(lp, cfg, x, moe_impl, with_aux=True)


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, moe_impl: str = "dense", q_block: int = 512,
            unroll: bool = False, mlstm_chunk: int = 0,
            remat_policy: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward -> (logits [B, S, Vp] float32, aux loss).

    ``params`` are float32 masters (cast here, the casts carrying the
    gradient to them) or compute copies (``compute_params(..., train=
    True)``, used as they are).  ``remat_policy="full"`` recomputes each
    layer in the backward (``torch.utils.checkpoint``, non-reentrant), as
    ``jax.checkpoint`` around the JAX package's scanned layer; ``"none"``
    keeps every activation; ``"dots"`` (save the products' outputs) is not
    ported (ROADMAP queue A item 13).  ``moe_impl`` picks the MoE block
    (``"dense"``, or ``"sparse"``: the capacity dispatch); the aux loss is
    the MoE layers' summed in layer order (0 for the dense family).
    ``unroll`` and ``mlstm_chunk`` are accepted and have no effect."""
    check_dense(cfg)
    if remat_policy not in REMAT_POLICIES:
        if remat_policy == "dots":
            raise NotImplementedError(
                "remat_policy='dots' (save the products' outputs) is not "
                "ported: ROADMAP queue A item 13")
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES} or "
                         f"'dots', got {remat_policy!r}")
    p = compute_params(params, train=True)
    tokens = batch["tokens"]
    x = p["embed"][tokens.long()].to(COMPUTE_DTYPE)
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(
        B, S)
    rope = (rope_cos_sin(pos, cfg.head_dim_, cfg.rope_theta)
            if cfg.rope_theta > 0 else None)
    windows = layer_windows(cfg)
    remat = remat_policy == "full" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(p["layers"]):
        body = functools.partial(_layer, lp, cfg, int(windows[i]), pos,
                                 q_block, rope, moe_impl)
        x, a = checkpoint(body, x, use_reentrant=False) if remat else body(x)
        if a is not None:
            aux = aux + a
    logits = lm_head(p, x, cfg.norm_eps)
    return logits, aux


def token_ce_loss(logits: torch.Tensor, tokens: torch.Tensor,
                  aux=0.0) -> torch.Tensor:
    """Next-token CE + z-loss (+ MoE aux) from full-sequence logits, over
    all ``vocab_padded`` columns (the padded ones too, as the JAX
    package's)."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    logp = torch.log_softmax(logits, dim=-1)
    # -logp at each target; nll_loss's backward writes each row once
    nll = F.nll_loss(logp.reshape(-1, logp.shape[-1]), targets.reshape(-1),
                     reduction="none")
    z = torch.logsumexp(logits, dim=-1)
    zloss = 1e-4 * (z ** 2)
    return nll.mean() + zloss.mean() + MOE_AUX_WEIGHT * torch.as_tensor(
        aux, dtype=torch.float32, device=logits.device)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, moe_impl: str = "dense", q_block: int = 512,
            unroll: bool = False, mlstm_chunk: int = 0,
            remat_policy: str = "full") -> torch.Tensor:
    """Next-token CE (+ z-loss + MoE aux) of ``forward``."""
    logits, aux = forward(params, batch, cfg, moe_impl=moe_impl,
                          q_block=q_block, unroll=unroll,
                          mlstm_chunk=mlstm_chunk, remat_policy=remat_policy)
    return token_ce_loss(logits, batch["tokens"], aux)


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
        x = _ffn(lp_i, cfg, x)[0]
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


def _decode_mixer(lp: Params, cfg: ArchConfig, x: torch.Tensor, window: int,
                  kv: PagedKV, slot: torch.Tensor, rope, gqa_impl: str,
                  attn_impl: str, commit) -> torch.Tensor:
    """One decode step through one attention layer of the ring cache."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    out, _ = A.decode_attention_block(
        lp["mixer"], h, kv, slot, n_heads=cfg.q_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_, window=window,
        qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps, rope=rope,
        gqa_impl=gqa_impl, impl=attn_impl, commit=commit)
    return x + out


def decode_step(params: Params, state: Params, tokens: torch.Tensor,
                cfg: ArchConfig, *, gqa_impl: str = "repeat",
                sample_greedy: bool = False, attn_impl: str = "auto",
                commit: Optional[torch.Tensor] = None):
    """One token for every sequence of the batch through the dense ring
    cache of ``init_decode_state``; ``tokens [B, 1]``, every slot at the
    state's one position ``pos``.

    Returns ``(logits [B, Vp] float32, state)``, or with ``sample_greedy``
    ``(next tokens [B] int32, state)`` (the argmax stays on the device).
    The state is updated in place: each layer writes its cell ``pos % S``
    and ``pos`` advances by one.  ``commit`` (a 0-dim bool on the device)
    makes the step conditional without a host sync: False drops every
    write and leaves ``pos`` as it was (the JAX device batcher skips the
    step with ``lax.cond`` instead).  Each layer attends through the
    paged backends over ``nn.attention.dense_view`` of its cache.
    """
    check_dense(cfg)
    pos = state["pos"]
    ck, cv = state["kv"]
    sk, sv = state.get("kv_scales", (None, None))
    dev = tokens.device
    B, S = tokens.shape[0], ck.shape[2]
    positions = pos.to(torch.int32).reshape(1, 1).repeat(B, 1)  # a copy
    slot = torch.remainder(pos.long(), S).reshape(1)
    tbl = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    rope = (rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)
            if cfg.rope_theta > 0 else None)
    x = params["embed"][tokens.long()]
    windows = layer_windows(cfg)
    for i, lp_i in enumerate(params["layers"]):
        kv = A.dense_view(ck[i], cv[i], None if sk is None else sk[i],
                          None if sv is None else sv[i], tbl, positions)
        x = _decode_mixer(lp_i, cfg, x, int(windows[i]), kv, slot, rope,
                          gqa_impl, attn_impl, commit)
        x = _ffn(lp_i, cfg, x)[0]
    logits = lm_head(params, x, cfg.norm_eps)[:, 0]
    pos.add_(1 if commit is None else commit.to(torch.int32))
    if sample_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32), state
    return logits, state
