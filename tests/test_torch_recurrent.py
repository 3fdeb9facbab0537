"""The port's recurrent blocks (``repro_torch.nn.recurrent``) against the
JAX package's (``repro.nn.recurrent``), on the CPU.

Parameters come from the JAX init functions (numpy, float32 masters); the
inputs from a numpy seed.  Each block and decode step runs in float32
(the parameters as they are) and in bf16 (the compute copies of
``arch.model.compute_params``, the JAX code casting the masters at use).

Tolerances, each with its reason:

* float32: ``F32_TOL`` (1e-5) of the JAX output's largest magnitude.  The
  same operations in float32; the RG-LRU's scan and the einsums sum in
  other orders (measured: at most 5e-7 of the largest magnitude).
* bf16: ``BF16_ULPS`` (4) bf16 ulps of the JAX output's largest magnitude.
  The products round to bf16 in both, but XLA may keep an elementwise
  chain (the bf16 causal conv) in float32 where torch rounds each op
  (measured: at most 2 ulps).  The float32 states of a bf16 decode step
  within ``STATE_TOL`` (1%) of their largest magnitude: one ulp of a bf16
  product moves them.
* The JAX package's own invariants (chunk == recurrence within 1e-3 of
  the outputs, ``tests/test_recurrent.py``) hold for the port with the
  same bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.nn import recurrent as JR  # noqa: E402
from repro_torch.arch.model import compute_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.nn import recurrent as TR  # noqa: E402

B, S, D, H = 2, 29, 32, 4
HD = D // H
F32_TOL = 1e-5
BF16_ULPS = 4
STATE_TOL = 0.01
X = np.random.default_rng(1).standard_normal((B, S, D)).astype(
    np.float32) * 0.5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _init(kind):
    key = jax.random.PRNGKey(0)
    if kind == "rglru":
        return JR.init_rglru(key, D, D)
    if kind == "mlstm":
        return JR.init_mlstm(key, D, H)
    return JR.init_slstm(key, D, H)


def _port_params(jp, dtype: str):
    """The JAX masters as the port's float32 tree, or its compute copies
    for bf16."""
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
          jp.items()}
    return compute_params(tp) if dtype == "bf16" else tp


def _inputs(dtype: str, x=X):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(got: torch.Tensor, want, dtype: str, what: str) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    m = np.abs(want).max()
    err = np.abs(got - want).max()
    if dtype == "f32":
        limit = F32_TOL * m
    else:
        limit = BF16_ULPS * 2.0 ** (np.floor(np.log2(m)) - 7)
    assert err <= limit, (what, err, limit)


def _block(kind, p, x, chunk=TR.MLSTM_CHUNK, R=TR):
    if kind == "rglru":
        return R.rglru_block(p, x)
    if kind == "mlstm":
        return R.mlstm_block(p, x, H, chunk=chunk)
    return R.slstm_block(p, x, H)


# ------------------------------------------------------------ blocks
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["rglru", "slstm"])
def test_block_matches_jax(kind, dtype):
    jp = _init(kind)
    jx, tx = _inputs(dtype)
    with torch.no_grad():
        got = _block(kind, _port_params(jp, dtype), tx)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, _block(kind, jp, jx, R=JR), dtype, kind)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("chunk", [4, 8, 64])  # 4 and 8 do not divide 29
def test_mlstm_block_matches_jax(chunk, dtype):
    jp = _init("mlstm")
    jx, tx = _inputs(dtype)
    with torch.no_grad():
        got = TR.mlstm_block(_port_params(jp, dtype), tx, H, chunk=chunk)
    _close(got, JR.mlstm_block(jp, jx, H, chunk=chunk), dtype,
           f"mlstm chunk {chunk}")


def _decode(kind, p, x, st, R=TR):
    if kind == "rglru":
        return R.rglru_decode(p, x, st)
    if kind == "mlstm":
        return R.mlstm_decode(p, x, st, H)
    return R.slstm_decode(p, x, st, H)


def _init_state(kind, R, **kw):
    if kind == "rglru":
        return R.rglru_init_state(B, D, **kw)
    if kind == "mlstm":
        return R.mlstm_init_state(B, H, HD, **kw)
    return R.slstm_init_state(B, H, HD, **kw)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_decode_matches_jax(kind, dtype):
    """Twelve decode steps from the zero state, each fed the JAX state of
    the step before: every output and every float32 state leaf."""
    jp = _init(kind)
    tp = _port_params(jp, dtype)
    jx, tx = _inputs(dtype)
    js = _init_state(kind, JR)
    for t in range(12):
        ts = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in js.items()}
        with torch.no_grad():
            out, new = _decode(kind, tp, tx[:, t:t + 1], ts)
        jout, js = _decode(kind, jp, jx[:, t:t + 1], js, R=JR)
        _close(out, jout, dtype, f"{kind} step {t}")
        assert set(new) == set(js)
        for k, v in new.items():
            want = np.asarray(js[k])
            assert v.dtype == torch.float32 and v.shape == want.shape, k
            err = np.abs(v.numpy() - want).max()
            tol = F32_TOL if dtype == "f32" else STATE_TOL
            assert err <= tol * max(np.abs(want).max(), 1e-30), (kind, t, k,
                                                                 err)


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_init_matches_jax_layout(kind):
    """Every init function's keys, shapes and dtypes (the numbers come from
    a torch.Generator); the states' too, and the stabilizer's -1e30."""
    jp = _init(kind)
    gen = torch.Generator().manual_seed(0)
    tp = (TR.init_rglru(gen, D, D) if kind == "rglru" else
          TR.init_mlstm(gen, D, H) if kind == "mlstm" else
          TR.init_slstm(gen, D, H))
    assert {k: (tuple(v.shape), v.dtype) for k, v in tp.items()} == {
        k: (tuple(v.shape), torch.float32) for k, v in jp.items()}
    fixed = {"rglru": ("lam",), "mlstm": ("b_f",), "slstm": ("b_gates",)}
    for k in fixed[kind]:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, err_msg=k)
    js, ts = _init_state(kind, JR), _init_state(kind, TR)
    assert set(js) == set(ts)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)


# ------------------------------------------------ the JAX invariants
def _unroll(kind, p, x):
    st = _init_state(kind, TR)
    outs = []
    for t in range(x.shape[1]):
        o, st = _decode(kind, p, x[:, t:t + 1], st)
        outs.append(o)
    return torch.cat(outs, 1)


@pytest.mark.parametrize("kind,chunk", [("mlstm", 4), ("mlstm", 8),
                                        ("mlstm", 64), ("rglru", 0),
                                        ("slstm", 0)])
def test_block_equals_recurrence(kind, chunk):
    """Mirror of ``tests/test_recurrent.py``: the parallel or chunked form
    equals the step-by-step recurrence in float32 within 1e-3."""
    tp = _port_params(_init(kind), "f32")
    x = torch.from_numpy(X)
    with torch.no_grad():
        blk = _block(kind, tp, x, chunk=chunk or TR.MLSTM_CHUNK)
        rec = _unroll(kind, tp, x)
    assert (blk - rec).abs().max().item() < 1e-3


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_state_is_o1(kind):
    """The long_500k enabler: the decode state's size does not depend on
    the sequence, and a step leaves it the same shapes."""
    st = _init_state(kind, TR)
    n = sum(v.numel() for v in st.values())
    want = {"rglru": B * (D + 3 * D), "mlstm": B * (H * HD * HD + H * HD + H
                                                    + 3 * D),
            "slstm": 4 * B * H * HD}[kind]
    assert n == want
    tp = _port_params(_init(kind), "f32")
    with torch.no_grad():
        _, new = _decode(kind, tp, torch.from_numpy(X[:, :1]), st)
    assert {k: v.shape for k, v in new.items()} == {k: v.shape
                                                    for k, v in st.items()}


# ------------------------------------------------------------ details
@pytest.mark.parametrize("fn", ["softplus", "log_sigmoid"])
def test_softplus_and_log_sigmoid_match_jax(fn):
    """jax.nn's definitions over [-100, 100], past ``F.softplus``'s
    threshold of 20 where it would return x itself: within 2 float32 ulps
    of the value's magnitude (the same logaddexp, libm's exp and log1p)."""
    x = np.concatenate([np.linspace(-100, 100, 2001),
                        [-1e30, -30.0, 19.9, 20.0, 20.1, 30.0]]).astype(
        np.float32)
    got = getattr(TR, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jax.nn, fn)(jnp.asarray(x)))
    ulps = np.abs(got - want) / np.spacing(np.maximum(np.abs(want),
                                                      np.float32(1e-30)))
    assert ulps.max() <= 2, (x[np.argmax(ulps)], ulps.max())


def test_mlstm_gate_weights_pad_and_fuse():
    """``w_i`` and ``w_f`` ([D, H], N = 4 at xlstm-125m, 2 here) become one
    ``w_if`` with 2H columns zero-padded to a multiple of 8, the third
    weight of the q/k launch; the block and the decode read it, and the
    master tree's block (w_i, w_f fused on the fly) is the same function."""
    jp = JR.init_mlstm(jax.random.PRNGKey(3), D, 2)
    masters = _port_params(jp, "f32")
    comp = compute_params(masters)
    assert "w_i" not in comp and "w_f" not in comp
    w = comp["w_if"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (D, 8)
    assert torch.equal(w[:, :2], masters["w_i"].to(torch.bfloat16))
    assert torch.equal(w[:, 2:4], masters["w_f"].to(torch.bfloat16))
    assert not w[:, 4:].any()
    x = torch.from_numpy(X)
    with torch.no_grad():
        a = TR.mlstm_block(masters, x, 2, chunk=8)
        fused = dict(masters, w_if=TR.mlstm_gate_weights(masters["w_i"],
                                                         masters["w_f"]))
        del fused["w_i"], fused["w_f"]
        b = TR.mlstm_block(fused, x, 2, chunk=8)
    assert torch.equal(a, b)
    st = TR.mlstm_init_state(B, 2, D // 2)
    ops.reset_launch_counts()
    with torch.no_grad():
        TR.mlstm_decode(comp, x[:, :1].to(torch.bfloat16), st, 2)
    assert ops.launch_counts()["linear"] == 0  # the CPU runs the plain one


def test_gradients_flow_to_every_master():
    """The blocks in float32 carry a finite gradient to every parameter
    but none through the padded gate columns (the stabilizer's -inf mask
    and -1e30 start give no NaN)."""
    for kind in ("rglru", "mlstm", "slstm"):
        tp = _port_params(_init(kind), "f32")
        for v in tp.values():
            v.requires_grad_(True)
        out = _block(kind, tp, torch.from_numpy(X), chunk=8)
        out.square().mean().backward()
        for k, v in tp.items():
            assert v.grad is not None and torch.isfinite(v.grad).all(), (
                kind, k)
