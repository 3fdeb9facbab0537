"""Recurrent blocks: RG-LRU (RecurrentGemma/Griffin), mLSTM + sLSTM (xLSTM)
(mirrors ``repro.nn.recurrent``).

Training and prefill run the parallel forms (a scan by doubling for the
RG-LRU, the chunkwise stabilized form for the mLSTM, a loop over time for
the sLSTM's true hidden recurrence); decode carries O(1) state.  The JAX
package computes the recurrences outside any Pallas kernel
(``lax.associative_scan``, ``lax.scan``), so here they are plain torch in
float32; every product of an activation with a bf16 weight is
``ops.linear`` or ``ops.linear_group`` (the row-invariant kernel on the
card).

The two forms keep the JAX package's two dtypes: the blocks run the causal
conv in the activations' type on ``conv.astype(dt)`` (bf16, each product
and sum rounded), the decode steps in float32 on the float32 ``conv``.
The decode functions are pure: they return the new state, and
``arch.model.decode_step`` writes it into the batch's fixed buffers.

The mLSTM's input and forget gate products (``w_i``, ``w_f``: ``[D, H]``,
N = 4 at xlstm-125m) run as one weight ``w_if = [w_i | w_f]`` zero-padded
to a multiple of ``GATE_COLS`` columns (the kernel takes N a multiple of
8), the third member of the q/k launch; the block and the decode both read
``w_if`` (``mlstm_gate_weights``), so both compute the gates the same way.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import dense_init, gelu

__all__ = ["RGLRU_C", "MLSTM_CHUNK", "GATE_COLS", "softplus", "log_sigmoid",
           "init_rglru", "rglru_block", "rglru_decode", "rglru_init_state",
           "init_mlstm", "mlstm_gate_weights", "mlstm_block",
           "mlstm_init_state", "mlstm_decode", "init_slstm", "slstm_block",
           "slstm_init_state", "slstm_decode"]

Device = Union[str, torch.device]
RGLRU_C = 8.0
MLSTM_CHUNK = 256
GATE_COLS = 8  # w_if's columns are padded to a multiple of this
M_START = -1e30  # the stabilizer's start (float32: exp(-m) stays finite)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(
    -|x|))``, with no threshold (``F.softplus`` returns x past 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x) = min(x, 0) - log1p(exp(
    -|x|))``, which is ``F.logsigmoid``'s formula (it has no threshold),
    in one kernel."""
    return F.logsigmoid(x)


# ------------------------------------------------------------------ RG-LRU
def init_rglru(gen: Optional[torch.Generator], d_model: int, d_rnn: int,
               conv_width: int = 4, device: Device = "cpu") -> Dict:
    def dense(shape):
        return dense_init(gen, shape, device=device)

    return {
        "w_lin": dense((d_model, d_rnn)),
        "w_gate": dense((d_model, d_rnn)),
        "w_out": dense((d_rnn, d_model)),
        "w_rec_gate": dense((d_rnn, d_rnn)),
        "w_in_gate": dense((d_rnn, d_rnn)),
        "lam": torch.linspace(0.9, 0.999, d_rnn, dtype=torch.float32,
                              device=device),  # Λ
        "conv": dense((conv_width, d_rnn)) * 0.1,
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time in x's type.  x [B,S,R], w [W,R]."""
    W, S = w.shape[0], x.shape[1]
    pads = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):  # small static width
        out = out + pads[:, i:i + S, :] * w[i][None, None, :]
    return out


def _conv_step(hist: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The decode conv: ``sum_i hist[:, i] * w[i]`` in float32, added in
    the order i = 0..W-1.  hist [B,W,R], w [W,R] -> [B,R]."""
    w = w.float()
    out = hist[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        out = out + hist[:, i] * w[i]
    return out


def _rglru_coeffs(p: Dict, u: torch.Tensor):
    """u [B,S,R] (post-conv branch). Returns (a, b) of h_t = a h + b."""
    r, i = ops.linear_group(u, [p["w_rec_gate"], p["w_in_gate"]])
    r, i = torch.sigmoid(r), torch.sigmoid(i)
    lam = p["lam"].float()
    log_a = -RGLRU_C * softplus(-torch.log(lam / (1 - lam)))  # base log a < 0
    log_a = log_a[None, None, :] * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1 - torch.exp(2 * log_a), 1e-6)) * (
        i.float() * u.float())
    return a, b


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h = 0`` along axis 1, by doubling:
    after the round of offset d, ``(a_t, b_t)`` composes steps t-2d+1..t
    (the JAX package's ``associative_scan`` of the same combine, in another
    order of its float32 products)."""
    S, d = a.shape[1], 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], 1)
        d *= 2
    return b


def rglru_block(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Griffin recurrent block over a full sequence."""
    dt = x.dtype
    u, g = ops.linear_group(x, [p["w_lin"], p["w_gate"]])
    u = _causal_conv(u, p["conv"].to(dt))
    a, b = _rglru_coeffs(p, u)
    h = _scan(a, b)
    return ops.linear(h.to(dt) * gelu(g), p["w_out"])


def rglru_decode(p: Dict, x: torch.Tensor,
                 state: Dict) -> Tuple[torch.Tensor, Dict]:
    """x [B,1,D]; state {h [B,R] f32, conv [B,W-1,R] f32}."""
    dt = x.dtype
    u_t, g = ops.linear_group(x, [p["w_lin"], p["w_gate"]])  # [B,1,R]
    hist = torch.cat([state["conv"], u_t.float()], 1)
    u_c = _conv_step(hist, p["conv"])[:, None]
    a, b = _rglru_coeffs(p, u_c.to(dt))
    h = a[:, 0] * state["h"] + b[:, 0]
    out = ops.linear(h[:, None, :].to(dt) * gelu(g), p["w_out"])
    return out, {"h": h, "conv": hist[:, 1:]}


def rglru_init_state(batch: int, d_rnn: int, conv_width: int = 4,
                     device: Device = "cpu") -> Dict:
    return {
        "h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, d_rnn),
                            dtype=torch.float32, device=device),
    }


# ------------------------------------------------------------------ mLSTM
def init_mlstm(gen: Optional[torch.Generator], d_model: int, n_heads: int,
               device: Device = "cpu") -> Dict:
    def dense(shape):
        return dense_init(gen, shape, device=device)

    return {
        "wq": dense((d_model, d_model)),
        "wk": dense((d_model, d_model)),
        "wv": dense((d_model, d_model)),
        "w_i": dense((d_model, n_heads)) * 0.1,
        "w_f": dense((d_model, n_heads)) * 0.1,
        "b_f": torch.full((n_heads,), 3.0, dtype=torch.float32,
                          device=device),  # open forget gates
        "w_gate": dense((d_model, d_model)),
        "w_out": dense((d_model, d_model)),
        "conv": dense((4, d_model)) * 0.1,
    }


def mlstm_gate_weights(w_i: torch.Tensor, w_f: torch.Tensor) -> torch.Tensor:
    """``[w_i | w_f]`` ``[D, 2H]`` zero-padded to a multiple of
    ``GATE_COLS`` columns, in their type (carries a gradient to both)."""
    w = torch.cat([w_i, w_f], 1)
    return F.pad(w, (0, -w.shape[1] % GATE_COLS))


def _gates_w(p: Dict) -> torch.Tensor:
    return p["w_if"] if "w_if" in p else mlstm_gate_weights(p["w_i"],
                                                            p["w_f"])


def _gates(p: Dict, g: torch.Tensor, n_heads: int):
    """(log_i, log_f) float32 ``[..., H]`` from the ``w_if`` product."""
    log_i = g[..., :n_heads].float()
    log_f = log_sigmoid(g[..., n_heads:2 * n_heads].float() + p["b_f"].float())
    return log_i, log_f


def mlstm_block(p: Dict, x: torch.Tensor, n_heads: int,
                chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """Chunkwise-parallel stabilized mLSTM: chunks of width ``chunk``
    carrying the (C, n, m) state between them, quadratic within a chunk,
    linear across; equal to the recurrent form."""
    dt = x.dtype
    B, S, D = x.shape
    hd = D // n_heads
    W = min(chunk, S)
    pad = (-S) % W
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    Sp = S + pad
    u = _causal_conv(x, p["conv"].to(dt)) + x
    q, k, g = ops.linear_group(u, [p["wq"], p["wk"], _gates_w(p)])
    v, gate = ops.linear_group(x, [p["wv"], p["w_gate"]])
    log_i, log_f = _gates(p, g, n_heads)  # [B,Sp,H]
    nc = Sp // W

    def chunks(t):  # [B,Sp,...] -> [B,nc,W,...]
        return t.reshape(B, nc, W, *t.shape[2:])

    qc = chunks(q.reshape(B, Sp, n_heads, hd))
    kc = chunks(k.reshape(B, Sp, n_heads, hd))
    vc = chunks(v.reshape(B, Sp, n_heads, hd))
    lic, lfc = chunks(log_i), chunks(log_f)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    mask = torch.ones((W, W), dtype=torch.bool, device=x.device).tril()
    C = torch.zeros((B, n_heads, hd, hd), dtype=torch.float32,
                    device=x.device)
    n = torch.zeros((B, n_heads, hd), dtype=torch.float32, device=x.device)
    m = torch.full((B, n_heads), M_START, dtype=torch.float32,
                   device=x.device)
    hs = []
    for c in range(nc):
        qi, ki, vi, li, lf = (t[:, c] for t in (qc, kc, vc, lic, lfc))
        L = torch.cumsum(lf, 1)  # [B,W,H] within-chunk decay
        # per-query stabilizer: max(state decay, intra max)
        intra = L[:, :, None, :] - L[:, None, :, :] + li[:, None, :, :]
        intra = torch.where(mask[None, :, :, None], intra, -torch.inf)
        intra_max = intra.amax(2)  # [B,W,H]
        state_decay = L + m[:, None, :]
        m_q = torch.maximum(state_decay, intra_max)
        a = torch.exp(state_decay - m_q)  # state weight per query
        wgt = torch.exp(intra - m_q[:, :, None, :])  # [B,W(i),W(j),H]
        qf = qi.float() * scale
        kf, vf = ki.float(), vi.float()
        s = wgt * torch.einsum("bihd,bjhd->bijh", qf, kf)
        num = torch.einsum("bijh,bjhd->bihd", s, vf) + \
            a[..., None] * torch.einsum("bhkv,bihk->bihv", C, qf)
        den = s.sum(2) + a * torch.einsum("bhk,bihk->bih", n, qf)
        den = torch.maximum(torch.abs(den), torch.exp(-m_q))
        hs.append(num / den[..., None])  # [B,W,H,hd]
        # the state at the end of the chunk
        Lw = L[:, -1]  # [B,H]
        m_new = torch.maximum(m + Lw, (Lw[:, None] - L + li).amax(1))
        kw = torch.exp(Lw[:, None] - L + li - m_new[:, None])  # [B,W,H]
        decay = torch.exp(m + Lw - m_new)
        C = decay[..., None, None] * C + torch.einsum(
            "bjh,bjhk,bjhv->bhkv", kw, kf, vf)
        n = decay[..., None] * n + torch.einsum("bjh,bjhk->bhk", kw, kf)
        m = m_new
    h = torch.stack(hs, 1).reshape(B, Sp, D)[:, :S].to(dt)
    return ops.linear(h * F.silu(gate[:, :S]), p["w_out"])


def mlstm_init_state(batch: int, n_heads: int, hd: int,
                     device: Device = "cpu") -> Dict:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"C": zeros(batch, n_heads, hd, hd), "n": zeros(batch, n_heads, hd),
            "m": torch.full((batch, n_heads), M_START, dtype=torch.float32,
                            device=device),
            "conv": zeros(batch, 3, n_heads * hd)}


def mlstm_decode(p: Dict, x: torch.Tensor, state: Dict,
                 n_heads: int) -> Tuple[torch.Tensor, Dict]:
    """x [B,1,D]; state {C [B,H,hd,hd], n [B,H,hd], m [B,H], conv
    [B,3,D]}, all float32."""
    dt = x.dtype
    B, _, D = x.shape
    hd = D // n_heads
    x0 = x[:, 0]
    hist = torch.cat([state["conv"], x0.float()[:, None]], 1)
    u = (_conv_step(hist, p["conv"]) + x0.float()).to(dt)
    q, k, g = ops.linear_group(u, [p["wq"], p["wk"], _gates_w(p)])
    v, gate = ops.linear_group(x0, [p["wv"], p["w_gate"]])
    q = q.reshape(B, n_heads, hd).float()
    k = k.reshape(B, n_heads, hd).float()
    v = v.reshape(B, n_heads, hd).float()
    log_i, log_f = _gates(p, g, n_heads)  # [B,H]
    m_new = torch.maximum(log_f + state["m"], log_i)
    fprime = torch.exp(log_f + state["m"] - m_new)
    iprime = torch.exp(log_i - m_new)
    C = fprime[..., None, None] * state["C"] + \
        iprime[..., None, None] * k[..., :, None] * v[..., None, :]
    n = fprime[..., None] * state["n"] + iprime[..., None] * k
    qs = q / float(np.float32(np.sqrt(hd)))
    num = torch.einsum("bhkv,bhk->bhv", C, qs)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qs)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, D).to(dt)
    out = ops.linear(h * F.silu(gate), p["w_out"])[:, None, :]
    return out, {"C": C, "n": n, "m": m_new, "conv": hist[:, 1:]}


# ------------------------------------------------------------------ sLSTM
def init_slstm(gen: Optional[torch.Generator], d_model: int, n_heads: int,
               device: Device = "cpu") -> Dict:
    hd = d_model // n_heads
    # fused gate projections: input (4 gates) and recurrent (4 gates,
    # block-diagonal per head)
    return {
        "w_gates": dense_init(gen, (d_model, 4 * d_model), device=device),
        "r_gates": dense_init(gen, (n_heads, hd, 4 * hd),
                              device=device) * 0.5,
        "b_gates": torch.cat([
            torch.zeros(d_model), torch.full((d_model,), 3.0),  # i, f biases
            torch.zeros(2 * d_model)]).to(device=device,
                                          dtype=torch.float32),
        "w_out": dense_init(gen, (d_model, d_model), device=device),
    }


def _slstm_consts(p: Dict, n_heads: int):
    """The sLSTM's float32 recurrent weight ``[H, hd, 4hd]`` and its
    biases as ``[H, 4, hd]``, made once a call."""
    r = p["r_gates"].float()
    hd = r.shape[1]
    b = p["b_gates"].float().reshape(4, n_heads, hd).transpose(0, 1)
    return r, b


def _slstm_cell(r, b, z, c, n, m, h):
    """One step of the sLSTM from its input gates ``z [B, H, 4, hd]``
    (float32; the JAX step's ``g = z + rec + b``, each op in its order):
    the new (c, n, m, h), each [B,H,hd].  ``log_f + m`` is taken once,
    where the JAX step writes it twice."""
    B, H, _, hd = z.shape
    rec = torch.einsum("bhd,hdk->bhk", h, r).reshape(B, H, 4, hd)
    g = z + rec + b
    log_i = g[:, :, 0]
    log_f = log_sigmoid(g[:, :, 1])
    zin = torch.tanh(g[:, :, 2])
    o = torch.sigmoid(g[:, :, 3])
    lfm = log_f + m
    m_new = torch.maximum(lfm, log_i)
    ip = torch.exp(log_i - m_new)
    fp = torch.exp(lfm - m_new)
    c = fp * c + ip * zin
    n = fp * n + ip
    h = o * c / torch.clamp_min(n, 1.0)
    return c, n, m_new, h


def slstm_block(p: Dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """True hidden-state recurrence: a loop over time."""
    dt = x.dtype
    B, S, D = x.shape
    hd = D // n_heads
    wx = ops.linear(x, p["w_gates"]).float()  # [B,S,4D]
    # [S, B, H, 4, hd]: each step's gates a contiguous slice
    z = wx.reshape(B, S, 4, n_heads, hd).permute(1, 0, 3, 2, 4).contiguous()
    r, b = _slstm_consts(p, n_heads)
    st = slstm_init_state(B, n_heads, hd, device=x.device)
    c, n, m, h = st["c"], st["n"], st["m"], st["h"]
    hs = []
    for t in range(S):
        c, n, m, h = _slstm_cell(r, b, z[t], c, n, m, h)
        hs.append(h)
    hs = torch.stack(hs, 1).reshape(B, S, D).to(dt)
    return ops.linear(hs, p["w_out"])


def slstm_init_state(batch: int, n_heads: int, hd: int,
                     device: Device = "cpu") -> Dict:
    def zeros():
        return torch.zeros((batch, n_heads, hd), dtype=torch.float32,
                           device=device)

    return {"c": zeros(), "n": zeros(),
            "m": torch.full((batch, n_heads, hd), M_START,
                            dtype=torch.float32, device=device),
            "h": zeros()}


def slstm_decode(p: Dict, x: torch.Tensor, state: Dict,
                 n_heads: int) -> Tuple[torch.Tensor, Dict]:
    """x [B,1,D]; state {c, n, m, h} [B,H,hd] float32."""
    dt = x.dtype
    B, _, D = x.shape
    hd = D // n_heads
    z = ops.linear(x[:, 0], p["w_gates"]).float().reshape(
        B, 4, n_heads, hd).transpose(1, 2)
    r, b = _slstm_consts(p, n_heads)
    c, n, m, h = _slstm_cell(r, b, z, state["c"], state["n"], state["m"],
                             state["h"])
    out = ops.linear(h.reshape(B, D).to(dt), p["w_out"])[:, None, :]
    return out, {"c": c, "n": n, "m": m, "h": h}
