"""The decoder families: the training forward and the serve paths (mirrors
``repro.arch.model``).

Ported here, for the dense, MoE, recurrent (``ssm``: xLSTM) and hybrid
(RecurrentGemma) families: ``layer_windows``, ``macro_pattern``,
``init_params`` (float32 masters with ``masters=True``), ``forward``,
``lm_head``, ``token_ce_loss`` and ``loss_fn`` (training),
``init_paged_kv`` and ``paged_decode_step`` (with ``all_positions``;
attention stacks only, as in the JAX package), ``init_decode_state`` and
``decode_step`` (the dense ring cache, and the recurrent states).  The JAX
package scans stacked layers with ``lax.scan``; here the layers are a list
walked by a Python loop (``repro_torch.tree`` gives the JAX package's
stacked view where a rule needs it), and each layer writes its slice of
the ``[n_layers, N, page, KV, hd]`` pools, or of the ``[n_layers, B, S,
KV, hd]`` ring cache, in place.

A config with a ``block_pattern`` keeps the JAX package's layout:
``params["macros"]["m{i}_{kind}"]`` is a list of ``n_macro`` layer dicts
(a stack: the JAX leaf is ``[n_macro, ...]``) and ``params["tail"]`` a
list of the ``n_tail`` remainder layers (indexed: the JAX package keeps it
an unstacked list).  ``forward`` runs the macros in order, recomputing each
macro in the backward under ``"full"`` or ``"dots"`` remat
(``jax.checkpoint`` around the JAX package's scanned macro body), then
the tail; every attention layer of a macro or the tail uses
``local_window``.  The recurrent mixers
are ``nn.recurrent``'s.  The decode state holds, beside ``pos``, one entry
a pattern position (``m{i}_kv``, ``m{i}_rglru``, ``m{i}_mlstm``,
``m{i}_slstm``, stacked over the macros) and one a tail layer
(``tail{i}_*``), with the JAX package's keys, shapes and dtypes; its
attention rings hold ``min(cache_len, local_window)`` cells, and an int8
request falls back to bf16 there, as in the JAX package.

Parameters: the trainer keeps float32 masters; the forward computes on
the copies the JAX forward makes at each use (``compute_params``):
matrices, biases and the LM head in bf16 (its ``astype(bfloat16)``),
norm scales and the leaves the JAX code reads as float32 (``FLOAT32_LEAVES``:
the RG-LRU's ``lam`` and ``conv``, the mLSTM's ``b_f`` and ``conv``, the
sLSTM's ``b_gates`` and ``r_gates``) in float32, and the embedding in bf16
for serving or, for training, float32 (JAX gathers rows of the float32
master and then casts, so the embedding's gradient is scatter-added in
float32).  The mLSTM's ``w_i`` and ``w_f`` become one padded ``w_if``
(``nn.recurrent.mlstm_gate_weights``).  A serve engine holds the compute
copies only, made once at load.  Every product is ``ops.linear``, or
``ops.linear_group`` for the products of one input (q/k/v, gate/up, the
RG-LRU's lin/gate and its two gates, the mLSTM's q/k/gates and v/gate;
the row-invariant kernel on the card, one launch a group, with a gradient
in training); the head's is the JAX head's bf16 x bf16 einsum with
float32 accumulation (``preferred_element_type=float32``): the logits are
never rounded to bf16.

The MoE family (``n_experts``) runs through the same paths: a layer's
``moe`` subtree (``nn.moe``; float32 masters in the JAX layout, the serve
copy with the experts' gate and up flattened to ``[D, E * F]``) takes the
place of its ``mlp``, ``_ffn`` runs ``nn.moe.moe_block`` (the JAX
package's default dense dispatch; ``moe_impl="sparse"`` its capacity
dispatch, in plain torch), and ``forward`` returns the summed aux loss as
the JAX forward does.  The serve steps discard the aux loss, as the JAX
package's do, and do not compute it.

The VLM family (internvl2-2b) adds ``frontend_proj`` ``[frontend_dim,
D]``: with ``"patches"`` in the batch the forward puts ``patches @
frontend_proj`` (``ops.linear``, bf16) ahead of the token embeddings, and
``loss_fn`` drops the logits of those positions.  Its decode is text-only,
as the JAX package's (ROADMAP C.14): the dense and paged serve paths run
it as a dense model.

The enc-dec family (seamless-m4t-large-v2) adds ``enc_layers`` (a list of
``n_encoder_layers`` attention layers), ``enc_ln_f``, ``cross_layers`` (a
list of ``n_layers`` attention layers whose ``mixer`` and ``ln1`` the
decoder's cross-attention reads; their ``ln2`` and ``mlp`` are JAX leaves
no forward reads, kept for the checkpoint and AdamW's decay) and
``frontend_proj``.  ``forward`` encodes ``batch["frames"]``
(``_encode``: the frontend product, then non-causal attention with RoPE
and the MLP a layer, ``enc_ln_f``), then runs the decoder
(``_dec_layer``: causal self-attention, cross-attention over
``nn.attention.cross_kv`` of the encoder's output, the MLP); each encoder
and decoder layer is recomputed in the backward whatever
``remat_policy`` says, as the JAX package's ``jax.checkpoint(body)``.  The
decode state adds ``cross``, ``[n_layers, B, frontend_seq, KV, hd]`` bf16
planes, zero as the JAX package leaves them (ROADMAP C.13);
``encode_cross`` computes them from frames, and ``decode_step`` reads them
through ``nn.attention.cross_decode_attention`` (plain torch, the JAX
einsums' roundings).  The paged cache refuses enc-dec, as in the JAX
package.

MoE training takes the dense dispatch through ``ops.moe_down_combine``
with a gradient (the kernel's forward, the JAX VJP of its two einsums as
``torch.bmm`` in the backward).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import tensor_device
from ..kernels import ops
from ..kernels.linear import DOTS_OP
from ..nn import attention as A
from ..nn import recurrent as R
from ..nn.attn_backend import PagedKV
from ..nn.common import dense_init, embed_init, rms_norm, rope_cos_sin
from ..nn.mlp import init_mlp, mlp_block
from ..nn.moe import compute_moe, init_moe, moe_block, moe_block_sparse
from .config import ArchConfig

Params = Dict[str, Any]
COMPUTE_DTYPE = torch.bfloat16
MOE_AUX_WEIGHT = 0.01
REMAT_POLICIES = ("full", "dots", "none")

__all__ = ["COMPUTE_DTYPE", "FLOAT32_LEAVES", "layer_windows",
           "macro_pattern", "init_params", "compute_params", "forward",
           "lm_head", "token_ce_loss", "loss_fn", "init_paged_kv",
           "paged_decode_step", "init_decode_state", "decode_step",
           "encode_cross", "unread"]

# leaves the JAX code reads as float32 masters (the blocks cast ``conv``
# to the activations' type where they use it)
FLOAT32_LEAVES = ("lam", "conv", "b_f", "b_gates", "r_gates")


def unread(key: str) -> bool:
    """Whether the leaf of ``key`` (a ``tree.leaves`` key) is one no forward
    reads: an enc-dec cross layer's ``ln2`` and ``mlp``.  Its gradient is
    zero, as in JAX; any other leaf without one is a fault."""
    return key.split("/")[:2] in (["cross_layers", "ln2"],
                                  ["cross_layers", "mlp"])


def check_paged(cfg: ArchConfig) -> None:
    """The paged cache serves attention stacks only (the JAX package's
    ``init_paged_kv`` refuses the others with this ``ValueError``)."""
    if cfg.block_pattern or cfg.family == "encdec":
        raise ValueError("paged KV cache supports dense attention "
                         f"stacks only (got family={cfg.family!r})")


def layer_windows(cfg: ArchConfig, n: Optional[int] = None) -> np.ndarray:
    """Per-layer attention window (0 = global)."""
    n = n or cfg.n_layers
    if cfg.global_every:
        return np.array(
            [0 if (l + 1) % cfg.global_every == 0 else cfg.local_window
             for l in range(n)], np.int32)
    return np.full(n, cfg.local_window, np.int32)


def macro_pattern(cfg: ArchConfig) -> Tuple[Tuple[str, ...], int, int]:
    """(pattern, n_macro, n_tail) for heterogeneous stacks."""
    pat = cfg.block_pattern or ("attn",)
    return pat, cfg.n_layers // len(pat), cfg.n_layers % len(pat)


# ------------------------------------------------------------------ init
def _init_mixer(gen, cfg: ArchConfig, kind: str, device) -> Params:
    if kind in ("attn", "attn_local"):
        mixer = A.init_attention(gen, cfg.d_model, cfg.q_heads,
                                 cfg.n_kv_heads, cfg.head_dim_, cfg.qkv_bias,
                                 cfg.qk_norm, device=device)
        if cfg.q_heads != cfg.n_heads:  # zero pad heads: exactness
            cut = cfg.n_heads * cfg.head_dim_
            mixer["wq"][:, cut:] = 0.0
            mixer["wo"][cut:, :] = 0.0
        return mixer
    if kind == "rglru":
        return R.init_rglru(gen, cfg.d_model, cfg.d_model, device=device)
    if kind == "mlstm":
        return R.init_mlstm(gen, cfg.d_model, cfg.n_heads, device=device)
    if kind == "slstm":
        return R.init_slstm(gen, cfg.d_model, cfg.n_heads, device=device)
    raise ValueError(kind)


def _init_layer(gen, cfg: ArchConfig, device, kind: str = "attn") -> Params:
    mixer = _init_mixer(gen, cfg, kind, device)
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
    dev = tensor_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    conv = (lambda t: t) if masters else compute_params
    Vp, D = cfg.vocab_padded, cfg.d_model
    params: Params = conv({
        "embed": embed_init(gen, (Vp, D), device=dev),
        "head": dense_init(gen, (D, Vp), device=dev),
        "ln_f": torch.zeros((D,), dtype=torch.float32, device=dev),
    })
    if cfg.block_pattern:
        pat, n_macro, n_tail = macro_pattern(cfg)
        params["macros"] = {
            f"m{i}_{kind}": [conv(_init_layer(gen, cfg, dev, kind))
                             for _ in range(n_macro)]
            for i, kind in enumerate(pat)}
        params["tail"] = [conv(_init_layer(gen, cfg, dev, pat[i]))
                          for i in range(n_tail)]
    else:
        params["layers"] = [conv(_init_layer(gen, cfg, dev))
                            for _ in range(cfg.n_layers)]
    if cfg.n_encoder_layers:
        params["enc_layers"] = [conv(_init_layer(gen, cfg, dev))
                                for _ in range(cfg.n_encoder_layers)]
        params["enc_ln_f"] = torch.zeros((D,), dtype=torch.float32,
                                         device=dev)
        params["cross_layers"] = [conv(_init_layer(gen, cfg, dev))
                                  for _ in range(cfg.n_layers)]
    if cfg.frontend:
        params.update(conv({"frontend_proj": dense_init(
            gen, (cfg.frontend_dim, D), device=dev)}))
    return params


def _compute(name: str, t: torch.Tensor, train: bool) -> torch.Tensor:
    """One float32 master -> its compute copy (see the module docstring)."""
    if name.startswith("ln") or name.endswith(("_norm", "ln_f")) or (
            name in FLOAT32_LEAVES) or (train and name == "embed"):
        return t.float()
    return t.to(COMPUTE_DTYPE)


def compute_params(tree, train: bool = False):
    """A (sub)tree of float32 masters -> the compute copies, by name; with
    ``train`` the embedding stays float32.  The casts carry a gradient, and
    a tree of compute copies maps to itself.  An mLSTM mixer's ``w_i`` and
    ``w_f`` become its one ``w_if``."""
    if isinstance(tree, list):
        return [compute_params(x, train) for x in tree]
    out = {}
    for k, v in tree.items():
        if k == "w_f" and "w_i" in tree:
            continue
        if k == "w_i" and "w_f" in tree:
            out["w_if"] = R.mlstm_gate_weights(_compute(k, v, train),
                                               _compute("w_f", tree["w_f"],
                                                        train))
        elif k == "moe":
            out[k] = compute_moe(v)
        elif isinstance(v, (dict, list)):
            out[k] = compute_params(v, train)
        else:
            out[k] = _compute(k, v, train)
    return out


def init_paged_kv(cfg: ArchConfig, n_pages: int, page_size: int,
                  kv_dtype: str = "bf16",
                  device: Union[str, torch.device] = "cuda") -> PagedKV:
    """The physical page pool, ``[n_layers, n_pages, page, KV, hd]`` bf16,
    or int8 with float32 scale planes ``[..., KV, 1]``, zero-filled.
    Attention stacks only: a ``block_pattern`` config raises the JAX
    package's ``ValueError``."""
    check_paged(cfg)
    device = tensor_device(device)
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


def _recurrent_state(cfg: ArchConfig, kind: str, batch: int,
                     device) -> Params:
    hd = cfg.d_model // cfg.n_heads
    if kind == "rglru":
        return R.rglru_init_state(batch, cfg.d_model, device=device)
    if kind == "mlstm":
        return R.mlstm_init_state(batch, cfg.n_heads, hd, device=device)
    return R.slstm_init_state(batch, cfg.n_heads, hd, device=device)


def _state_key(kind: str, prefix: str) -> str:
    return f"{prefix}_kv" if kind == "attn" else f"{prefix}_{kind}"


def _macro_state(cfg: ArchConfig, batch: int, cache_len: int,
                 device) -> Params:
    """The recurrent families' decode state (see the module docstring)."""
    pat, n_macro, n_tail = macro_pattern(cfg)
    # windowed attn layers cache only the window
    attn_len = (min(cache_len, cfg.local_window) if cfg.local_window
                else cache_len)

    def kv_cache(n):
        shape = (n, batch, attn_len, cfg.n_kv_heads, cfg.head_dim_)
        return tuple(torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)
                     for _ in range(2))

    state: Params = {}
    for i, kind in enumerate(pat):
        if kind == "attn":
            state[f"m{i}_kv"] = kv_cache(n_macro)
        else:
            st = _recurrent_state(cfg, kind, batch, device)
            state[f"m{i}_{kind}"] = {
                k: v[None].repeat(n_macro, *[1] * v.dim())
                for k, v in st.items()}
    for i in range(n_tail):
        kind = pat[i]
        state[_state_key(kind, f"tail{i}")] = (
            kv_cache(1) if kind == "attn"
            else _recurrent_state(cfg, kind, batch, device))
    return state


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      kv_dtype: str = "bf16",
                      device: Union[str, torch.device] = "cuda") -> Params:
    """The dense decode state: ``pos``, one global position (a 0-dim int32
    tensor on the device, advanced in place by ``decode_step``), and the
    ring cache ``kv = (k, v)``, ``[n_layers, batch, cache_len, KV, hd]``
    bf16, or int8 with ``kv_scales`` float32 ``[..., KV, 1]``, zero-filled;
    for a ``block_pattern`` config the macro and tail states instead (the
    module docstring), an int8 request kept bf16; for an enc-dec config
    also ``cross = (k, v)``, ``[n_layers, batch, frontend_seq, KV, hd]``
    bf16 zeros (``encode_cross`` computes them), an int8 request kept
    bf16, as in the JAX package."""
    device = tensor_device(device)
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim_)
    state: Params = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.block_pattern:
        state.update(_macro_state(cfg, batch, cache_len, device))
        return state
    if cfg.family == "encdec":
        cshape = (cfg.n_layers, batch, cfg.frontend_seq or cache_len,
                  cfg.n_kv_heads, cfg.head_dim_)
        state["kv"] = tuple(torch.zeros(shape, dtype=COMPUTE_DTYPE,
                                        device=device) for _ in range(2))
        state["cross"] = tuple(torch.zeros(cshape, dtype=COMPUTE_DTYPE,
                                           device=device) for _ in range(2))
        return state
    if kv_dtype == "int8":
        sshape = shape[:-1] + (1,)
        state["kv"] = tuple(torch.zeros(shape, dtype=torch.int8,
                                        device=device) for _ in range(2))
        state["kv_scales"] = tuple(torch.zeros(sshape, dtype=torch.float32,
                                               device=device) for _ in range(2))
        return state
    state["kv"] = tuple(torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)
                        for _ in range(2))
    return state


# --------------------------------------------------------------- forward
def _positions(B: int, S: int, dev) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)


def _rope(cfg: ArchConfig, pos: torch.Tensor):
    return (rope_cos_sin(pos, cfg.head_dim_, cfg.rope_theta)
            if cfg.rope_theta > 0 else None)


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


def _mixer_fwd(lp: Params, cfg: ArchConfig, kind: str, x: torch.Tensor,
               window: int, positions, q_block: int, rope,
               mlstm_chunk: int) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind in ("attn", "attn_local"):
        out = A.attention_block(
            lp["mixer"], h, n_heads=cfg.q_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta, window=window,
            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps, positions=positions,
            q_block=q_block, rope=rope)
    elif kind == "rglru":
        out = R.rglru_block(lp["mixer"], h)
    elif kind == "mlstm":
        out = R.mlstm_block(lp["mixer"], h, cfg.n_heads,
                            chunk=mlstm_chunk or R.MLSTM_CHUNK)
    elif kind == "slstm":
        out = R.slstm_block(lp["mixer"], h, cfg.n_heads)
    else:
        raise ValueError(kind)
    return x + out


def _layer(lp: Params, cfg: ArchConfig, window: int, positions, q_block: int,
           rope, moe_impl: str, x: torch.Tensor, kind: str = "attn",
           mlstm_chunk: int = 0):
    """One layer (its mixer, then its MLP or MoE block) over the whole
    sequence: (x, the layer's aux loss, None for an MLP)."""
    x = _mixer_fwd(lp, cfg, kind, x, window, positions, q_block, rope,
                   mlstm_chunk)
    return _ffn(lp, cfg, x, moe_impl, with_aux=True)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``"dots"``: save the products' outputs (``ops.linear`` /
    ``linear_group``, the operator ``DOTS_OP``: JAX's
    ``dots_with_no_batch_dims_saveable`` saves exactly these), recompute
    everything else (attention's and the recurrences' batched einsums,
    ``moe_down_combine``, the elementwise work)."""
    return (CheckpointPolicy.MUST_SAVE if op is DOTS_OP
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, remat_policy: str, x: torch.Tensor):
    """``body(x)`` recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``): all of it under ``"full"``, all but the
    products' outputs under ``"dots"`` (a selective-checkpoint policy)."""
    if remat_policy == "dots":
        return checkpoint(body, x, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return checkpoint(body, x, use_reentrant=False)


def _macro(lps, pat, cfg: ArchConfig, positions, q_block: int, rope,
           moe_impl: str, mlstm_chunk: int, x: torch.Tensor):
    """One macro block: the pattern's layers in order -> (x, aux or
    None)."""
    aux = None
    for lp, kind in zip(lps, pat):
        x, a = _layer(lp, cfg, cfg.local_window, positions, q_block, rope,
                      moe_impl, x, kind, mlstm_chunk)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, moe_impl: str = "dense", q_block: int = 512,
            unroll: bool = False, mlstm_chunk: int = 0,
            remat_policy: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward -> (logits [B, S, Vp] float32, aux loss).

    ``params`` are float32 masters (cast here, the casts carrying the
    gradient to them) or compute copies (``compute_params(..., train=
    True)``, used as they are).  ``remat_policy="full"`` recomputes each
    layer in the backward (``torch.utils.checkpoint``, non-reentrant), as
    ``jax.checkpoint`` around the JAX package's scanned layer; ``"dots"``
    saves the products' outputs and recomputes the rest (``_remat``: the
    backward launches no product again, and the loss and every gradient
    are bitwise ``"full"``'s, the products being row-invariant); ``"none"``
    keeps every activation.  ``moe_impl`` picks the MoE block
    (``"dense"``, or ``"sparse"``: the capacity dispatch); the aux loss is
    the MoE layers' summed in layer order (0 for the dense family).
    ``mlstm_chunk`` is the mLSTM's chunk width (0: ``MLSTM_CHUNK``);
    ``unroll`` is accepted and has no effect.  A ``block_pattern`` config
    runs its macros, each one recomputed under ``"full"``, then its
    tail.  A VLM batch may carry ``"patches"`` ``[B, frontend_seq,
    frontend_dim]``, whose positions lead the logits; an enc-dec batch
    carries ``"frames"`` ``[B, S_enc, frontend_dim]``, and its forward
    ignores ``remat_policy`` as the JAX package's does (every layer is
    recomputed)."""
    if cfg.family == "encdec":
        return _encdec_forward(params, batch, cfg, q_block)
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {remat_policy!r}")
    p = compute_params(params, train=True)
    x = _embed_inputs(p, cfg, batch)
    B, S, _ = x.shape
    pos = _positions(B, S, x.device)
    rope = _rope(cfg, pos)
    remat = remat_policy != "none" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block_pattern:
        pat, n_macro, _ = macro_pattern(cfg)
        bodies = [functools.partial(
            _macro, [p["macros"][f"m{i}_{kind}"][j]
                     for i, kind in enumerate(pat)],
            pat, cfg, pos, q_block, rope, moe_impl, mlstm_chunk)
            for j in range(n_macro)]
        tail = [functools.partial(_layer, lp, cfg, cfg.local_window, pos,
                                  q_block, rope, moe_impl, kind=pat[i],
                                  mlstm_chunk=mlstm_chunk)
                for i, lp in enumerate(p["tail"])]
    else:
        windows = layer_windows(cfg)
        bodies = [functools.partial(_layer, lp, cfg, int(windows[i]), pos,
                                    q_block, rope, moe_impl)
                  for i, lp in enumerate(p["layers"])]
        tail = []
    for i, body in enumerate(bodies + tail):
        if remat and i < len(bodies):  # the JAX tail runs outside remat
            x, a = _remat(body, remat_policy, x)
        else:
            x, a = body(x)
        if a is not None:
            aux = aux + a
    logits = lm_head(p, x, cfg.norm_eps)
    return logits, aux


def _embed_inputs(p: Params, cfg: ArchConfig,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token (+ VLM patch) embedding -> ``[B, S_total, D]`` bf16: with
    ``"patches"`` in a VLM batch, ``patches @ frontend_proj`` leads the
    token embeddings."""
    x = p["embed"][batch["tokens"].long()].to(COMPUTE_DTYPE)
    if cfg.frontend == "vit" and "patches" in batch:
        pe = ops.linear(batch["patches"].to(COMPUTE_DTYPE),
                        p["frontend_proj"])
        x = torch.cat([pe, x], dim=1)
    return x


def _enc_layer(lp: Params, cfg: ArchConfig, pos, q_block: int, rope,
               x: torch.Tensor) -> torch.Tensor:
    """One encoder layer: non-causal attention, then the MLP."""
    hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + A.attention_block(
        lp["mixer"], hn, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta, window=0,
        qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps, positions=pos,
        causal=False, q_block=q_block, rope=rope)
    hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_block(lp["mlp"], hn, cfg.act)


def _encode(p: Params, cfg: ArchConfig, frames: torch.Tensor,
            q_block: int) -> torch.Tensor:
    """The enc-dec encoder over frame embeddings ``[B, S, frontend_dim]``
    (compute copies ``p``) -> ``[B, S, D]`` bf16; each layer recomputed in
    the backward, as the JAX package's ``jax.checkpoint(body)``."""
    h = ops.linear(frames.to(COMPUTE_DTYPE), p["frontend_proj"])
    B, S, _ = h.shape
    pos = _positions(B, S, h.device)
    rope = _rope(cfg, pos)
    remat = torch.is_grad_enabled()
    for lp in p["enc_layers"]:
        body = functools.partial(_enc_layer, lp, cfg, pos, q_block, rope)
        h = checkpoint(body, h, use_reentrant=False) if remat else body(h)
    return rms_norm(h, p["enc_ln_f"], cfg.norm_eps)


def _dec_layer(lp: Params, cp: Params, cfg: ArchConfig, pos, q_block: int,
               rope, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    """One decoder layer: causal self-attention, cross-attention over the
    encoder's output (no RoPE), then the MLP."""
    hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + A.attention_block(
        lp["mixer"], hn, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta, window=0,
        qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps, positions=pos,
        q_block=q_block, rope=rope)
    hn = rms_norm(x, cp["ln1"], cfg.norm_eps)
    kv = A.cross_kv(cp["mixer"], enc_out, cfg.n_kv_heads, cfg.head_dim_)
    x = x + A.attention_block(
        cp["mixer"], hn, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=0.0, window=0,
        qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps, positions=pos,
        kv_override=kv, q_block=q_block)
    hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_block(lp["mlp"], hn, cfg.act)


def _encdec_forward(params: Params, batch: Dict[str, torch.Tensor],
                    cfg: ArchConfig, q_block: int):
    """The enc-dec ``forward``: encode the frames, then the decoder stack
    over the tokens, each layer recomputed in the backward; aux 0."""
    p = compute_params(params, train=True)
    enc_out = _encode(p, cfg, batch["frames"], q_block)
    x = _embed_inputs(p, cfg, batch)
    B, S, _ = x.shape
    pos = _positions(B, S, x.device)
    rope = _rope(cfg, pos)
    remat = torch.is_grad_enabled()
    for lp, cp in zip(p["layers"], p["cross_layers"]):
        body = functools.partial(_dec_layer, lp, cp, cfg, pos, q_block, rope)
        x = (checkpoint(body, x, enc_out, use_reentrant=False) if remat
             else body(x, enc_out))
    logits = lm_head(p, x, cfg.norm_eps)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def encode_cross(params: Params, frames: torch.Tensor, cfg: ArchConfig,
                 q_block: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``cross`` planes of an enc-dec decode state from frame
    embeddings ``[B, frontend_seq, frontend_dim]``: ``nn.attention.
    cross_kv`` of each cross layer over ``_encode(frames)``, stacked to
    ``[n_layers, B, frontend_seq, KV, hd]`` bf16 (masters or compute
    copies).  Nothing in the JAX package writes ``state["cross"]``
    (ROADMAP C.13); this is the composition of its ``_encode`` and
    ``cross_kv``, and the serve engine keeps the zero planes."""
    if cfg.family != "encdec":
        raise ValueError(f"encode_cross needs an enc-dec config, got "
                         f"family={cfg.family!r}")
    p = compute_params({k: params[k] for k in (
        "frontend_proj", "enc_layers", "enc_ln_f", "cross_layers")})
    enc_out = _encode(p, cfg, frames, q_block)
    kvs = [A.cross_kv(cp["mixer"], enc_out, cfg.n_kv_heads, cfg.head_dim_)
           for cp in p["cross_layers"]]
    return (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))


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
    """Next-token CE (+ z-loss + MoE aux) of ``forward``; a VLM's logits
    drop the ``batch["patches"]`` positions first (a VLM batch without
    patches raises ``KeyError``, as the JAX ``loss_fn``)."""
    logits, aux = forward(params, batch, cfg, moe_impl=moe_impl,
                          q_block=q_block, unroll=unroll,
                          mlstm_chunk=mlstm_chunk, remat_policy=remat_policy)
    if cfg.family == "vlm" and cfg.frontend_seq:
        logits = logits[:, batch["patches"].shape[1]:]
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
    check_paged(cfg)
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
    rope = _rope(cfg, positions)
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
    paged backends over ``nn.attention.dense_view`` of its cache.  A
    ``block_pattern`` config runs its macros and tail (``_decode_macros``):
    each recurrent layer writes its new state over its buffers in place,
    each attention layer its ring cell; ``commit`` False writes every
    buffer back as it was.  An enc-dec config's layers are global
    self-attention, then cross-attention over the state's ``cross`` planes
    (``nn.attention.cross_decode_attention``; read, never written), then
    the MLP.
    """
    if cfg.block_pattern:
        x = _decode_macros(params, state, tokens, cfg, gqa_impl, attn_impl,
                           commit)
        return _decode_out(params, state, x, cfg, sample_greedy, commit)
    pos = state["pos"]
    ck, cv = state["kv"]
    sk, sv = state.get("kv_scales", (None, None))
    dev = tokens.device
    B, S = tokens.shape[0], ck.shape[2]
    positions = pos.to(torch.int32).reshape(1, 1).repeat(B, 1)  # a copy
    slot = torch.remainder(pos.long(), S).reshape(1)
    tbl = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    rope = _rope(cfg, positions)
    x = params["embed"][tokens.long()]
    encdec = cfg.family == "encdec"
    windows = np.zeros(cfg.n_layers, np.int32) if encdec else \
        layer_windows(cfg)
    for i, lp_i in enumerate(params["layers"]):
        kv = A.dense_view(ck[i], cv[i], None if sk is None else sk[i],
                          None if sv is None else sv[i], tbl, positions)
        x = _decode_mixer(lp_i, cfg, x, int(windows[i]), kv, slot, rope,
                          gqa_impl, attn_impl, commit)
        if encdec:
            cp = params["cross_layers"][i]
            h = rms_norm(x, cp["ln1"], cfg.norm_eps)
            x = x + A.cross_decode_attention(
                cp["mixer"], h, state["cross"][0][i], state["cross"][1][i],
                n_heads=cfg.n_heads, head_dim=cfg.head_dim_)
        x = _ffn(lp_i, cfg, x)[0]
    return _decode_out(params, state, x, cfg, sample_greedy, commit)


def _decode_out(params: Params, state: Params, x: torch.Tensor,
                cfg: ArchConfig, sample_greedy: bool, commit):
    """The step's head, then ``pos`` advanced (or kept, without commit)."""
    logits = lm_head(params, x, cfg.norm_eps)[:, 0]
    state["pos"].add_(1 if commit is None else commit.to(torch.int32))
    if sample_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32), state
    return logits, state


def _store(bufs: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
           commit: Optional[torch.Tensor]) -> None:
    """Write a recurrent layer's new state over its buffers in place; with
    ``commit`` False each buffer is written back as it was."""
    for k, v in new.items():
        dst = bufs[k]
        dst.copy_(v if commit is None else torch.where(commit, v, dst))


def _decode_macros(params: Params, state: Params, tokens: torch.Tensor,
                   cfg: ArchConfig, gqa_impl: str, attn_impl: str,
                   commit) -> torch.Tensor:
    """One decode step through the macros and the tail (the JAX package's
    ``decode_step`` for a ``block_pattern``): the hidden state before the
    head.  Every attention layer uses ``local_window`` over its ring of
    ``min(cache_len, local_window)`` cells."""
    pat, n_macro, n_tail = macro_pattern(cfg)
    pos = state["pos"]
    dev = tokens.device
    B = tokens.shape[0]
    x = params["embed"][tokens.long()]
    ring = next((state[k] for k in state if k.endswith("_kv")), None)
    if ring is not None:
        S = ring[0].shape[2]
        positions = pos.to(torch.int32).reshape(1, 1).repeat(B, 1)
        slot = torch.remainder(pos.long(), S).reshape(1)
        tbl = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
        rope = _rope(cfg, positions)

    def layer(lp, kind, cache, x):
        if kind == "attn":
            kv = A.dense_view(cache[0], cache[1], None, None, tbl, positions)
            x = _decode_mixer(lp, cfg, x, cfg.local_window, kv, slot, rope,
                              gqa_impl, attn_impl, commit)
        else:
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if kind == "rglru":
                out, new = R.rglru_decode(lp["mixer"], h, cache)
            elif kind == "mlstm":
                out, new = R.mlstm_decode(lp["mixer"], h, cache, cfg.n_heads)
            else:
                out, new = R.slstm_decode(lp["mixer"], h, cache, cfg.n_heads)
            _store(cache, new, commit)
            x = x + out
        return _ffn(lp, cfg, x)[0]

    for j in range(n_macro):
        for i, kind in enumerate(pat):
            st = state[_state_key(kind, f"m{i}")]
            cache = (tuple(t[j] for t in st) if kind == "attn"
                     else {k: v[j] for k, v in st.items()})
            x = layer(params["macros"][f"m{i}_{kind}"][j], kind, cache, x)
    for i in range(n_tail):
        kind = pat[i]
        st = state[_state_key(kind, f"tail{i}")]
        cache = tuple(t[0] for t in st) if kind == "attn" else st
        x = layer(params["tail"][i], kind, cache, x)
    return x
