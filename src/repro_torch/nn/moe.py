"""Mixture-of-Experts layer: top-k routing, stacked experts, shared experts
(mirrors ``repro.nn.moe``).

The masters keep the JAX package's layout: ``router [D, E]``, ``w_gate`` /
``w_up [E, D, F]``, ``w_down [E, F, D]`` and an optional ``shared`` MLP.
The serve copy (``compute_moe``) holds ``w_gate`` / ``w_up`` as ``[D, E *
F]`` bf16, column ``e * F + f`` being expert ``e``'s column ``f``, so that
both products of every expert are one ``ops.linear_group`` launch whose
``[M, E * F]`` outputs are JAX's ``"bsd,edf->bsef"`` laid out as ``[M, E,
F]``; it is made once, at load, and the card holds no second layout.

``moe_block`` is the JAX package's dense dispatch (its default
``moe_impl``): every expert runs on every token and the combine weights
keep each token's top-k.  On the card its products are ``ops.linear``
(the router, N = E), one ``ops.linear_group`` (the experts' gate and up),
``nn.mlp.mlp_block`` (the shared experts) and ``ops.moe_down_combine``
(the experts' down product and the combine, one launch), so each row's
bits depend on that row alone.  ``moe_block_sparse`` is the GShard
capacity dispatch, in plain torch: no path of the card launches it.

Routing follows JAX op by op: float32 logits of the bf16 product, padding
experts (qwen2-moe pads 60 to 64) at -1e30, a float32 softmax, ``top_k``
with the values descending and ties to the lower expert index (as
``jax.lax.top_k``; ``torch.topk`` promises no order among ties, so the
port ranks a key that holds the gate's bits and the index), the top-k
weights divided by their sum (added in slot order), and the Switch aux
loss.  The softmax's sum is ``nn.common.row_sum``, so a token's routing
does not depend on the other tokens of the step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..kernels import ops
from .common import ACTIVATIONS, dense_init, row_sum
from .mlp import init_mlp, mlp_block

__all__ = ["init_moe", "compute_moe", "route", "topk_weights", "moe_block",
           "moe_block_sparse"]

PAD_LOGIT = -1e30


def init_moe(gen: Optional[torch.Generator], d_model: int, moe_d_ff: int,
             n_experts_padded: int, n_shared: int, shared_d_ff: int,
             device: Union[str, torch.device] = "cpu") -> Dict:
    """float32 masters in the JAX package's layout (normal / sqrt(fan_in)
    from ``gen``; other numbers than ``jax.random``'s)."""
    E = n_experts_padded
    p = {
        "router": dense_init(gen, (d_model, E), device=device),
        "w_gate": dense_init(gen, (E, d_model, moe_d_ff), device=device),
        "w_up": dense_init(gen, (E, d_model, moe_d_ff), device=device),
        "w_down": dense_init(gen, (E, moe_d_ff, d_model), device=device),
    }
    if n_shared > 0:
        p["shared"] = init_mlp(gen, d_model, shared_d_ff, device=device)
    return p


def _flat(w: torch.Tensor) -> torch.Tensor:
    """``[E, D, F]`` -> ``[D, E * F]`` (a copy); a flat weight as it is."""
    if w.dim() == 2:
        return w
    E, D, F = w.shape
    return w.permute(1, 0, 2).reshape(D, E * F)


def compute_moe(p: Dict) -> Dict:
    """The compute copies of one layer's ``moe`` subtree: every matrix in
    bf16, ``w_gate`` / ``w_up`` flattened to ``[D, E * F]``.  The casts
    carry a gradient, and a tree of compute copies maps to itself."""
    bf16 = torch.bfloat16
    out = {k: _flat(v).to(bf16) if k in ("w_gate", "w_up") else v.to(bf16)
           for k, v in p.items() if k != "shared"}
    if "shared" in p:
        out["shared"] = {k: v.to(bf16) for k, v in p["shared"].items()}
    return out


def route(x: torch.Tensor, router: torch.Tensor, n_experts: int,
          top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(gates [..., E] float32, top_idx [..., k] int64, top_vals [..., k]
    float32)`` of ``x [..., D]``, the top-k weights normalised."""
    logits = ops.linear(x, router.to(x.dtype)).float()
    E = logits.shape[-1]
    if n_experts < E:  # mask padding experts
        pad = torch.arange(E, device=x.device) >= n_experts
        logits = logits.masked_fill(pad, PAD_LOGIT)
    unnorm = torch.exp(logits - logits.amax(-1, keepdim=True))
    gates = unnorm / row_sum(unnorm)
    # the gate's bits (monotone for gates >= 0) above the reversed index:
    # the larger gate first, and among equal gates the lower expert
    bits = gates.view(torch.int32).to(torch.int64)
    rev = (E - 1) - torch.arange(E, device=x.device, dtype=torch.int64)
    top_idx = (bits * E + rev).topk(top_k, dim=-1).indices
    return gates, top_idx, topk_weights(gates, top_idx)


def topk_weights(gates: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
    """The gates at ``top_idx`` divided by their sum (added in slot order,
    at least 1e-9): a token's combine weights."""
    top_vals = gates.gather(-1, top_idx)
    total = top_vals[..., 0]
    for j in range(1, top_idx.shape[-1]):
        total = total + top_vals[..., j]
    return top_vals / torch.clamp(total, min=1e-9)[..., None]


def moe_block(p: Dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              act: str = "silu", with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(output [B, S, D] in x's type, aux loss [] float32)`` of ``x [B, S,
    D]`` (any leading shape); with ``with_aux=False`` the aux loss is not
    computed (None), as the serve steps discard it."""
    fn = ACTIVATIONS[act]
    lead, D = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, D)
    gates, top_idx, top_vals = route(x2, p["router"], n_experts, top_k)
    E = gates.shape[-1]
    combine = torch.zeros_like(gates).scatter(-1, top_idx, top_vals)
    aux = None
    if with_aux:
        # Switch load balance: E * sum_e f_e * P_e
        density = (combine > 0).float().mean(0)
        aux = E * torch.sum(density * gates.mean(0))
    w_gate, w_up = _flat(p["w_gate"]), _flat(p["w_up"])
    if w_gate.dtype != x.dtype:
        w_gate, w_up = w_gate.to(x.dtype), w_up.to(x.dtype)
    h_gate, h_up = ops.linear_group(x2, [w_gate, w_up])
    h = (fn(h_gate) * h_up).reshape(x2.shape[0], E, -1)
    out = ops.moe_down_combine(h, p["w_down"].to(x.dtype),
                               combine.to(x.dtype))
    if "shared" in p:
        out = out + mlp_block(p["shared"], x2, act)
    return out.reshape(*lead, D), aux


def moe_block_sparse(p: Dict, x: torch.Tensor, *, n_experts: int,
                     top_k: int, act: str = "silu",
                     capacity_factor: float = 1.25
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based dispatch (GShard), the JAX package's
    ``moe_block_sparse`` in plain torch: tokens go to per-expert buffers of
    ``int(capacity_factor * N * top_k / E)`` slots in token order, a token
    past its expert's capacity is dropped for that expert, and the kept
    outputs are added back with their weights (in bf16, as the JAX
    scatter-add)."""
    dt = x.dtype
    fn = ACTIVATIONS[act]
    B, S, D = x.shape
    N = B * S
    xf = x.reshape(N, D)
    gates, top_idx, top_vals = route(xf, p["router"], n_experts, top_k)
    E = gates.shape[-1]
    cap = max(int(capacity_factor * N * top_k / E), 1)
    flat_idx = top_idx.reshape(-1)  # [N*k]
    onehot = torch.nn.functional.one_hot(flat_idx, E).to(torch.int32)
    pos = (torch.cumsum(onehot, 0) - 1).gather(1, flat_idx[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, pos, torch.zeros_like(pos))
    tok_ids = torch.arange(N, device=x.device).repeat_interleave(top_k)
    src = torch.where(keep[:, None], xf[tok_ids], torch.zeros_like(xf[tok_ids]))
    buf = torch.zeros((E, cap, D), dtype=dt, device=x.device)
    buf.index_put_((flat_idx, slot), src.to(dt), accumulate=True)
    F = p["w_down"].shape[1]
    wg = _flat(p["w_gate"]).to(dt).reshape(D, E, F)
    wu = _flat(p["w_up"]).to(dt).reshape(D, E, F)
    h = fn(torch.einsum("ecd,def->ecf", buf, wg))
    h = h * torch.einsum("ecd,def->ecf", buf, wu)
    eo = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))
    gathered = eo[flat_idx, slot]  # [N*k, D]
    w = (top_vals.reshape(-1) * keep).to(dt)
    outf = torch.zeros((N, D), dtype=dt, device=x.device)
    outf.index_add_(0, tok_ids, gathered * w[:, None])
    out = outf.reshape(B, S, D)
    density = torch.zeros(E, dtype=torch.float32, device=x.device)
    density.index_add_(0, flat_idx, keep.float() / N)
    aux = E * torch.sum(density / top_k * gates.mean(0))
    if "shared" in p:
        out = out + mlp_block(p["shared"], x, act)
    return out, aux
