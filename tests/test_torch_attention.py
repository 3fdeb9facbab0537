"""The port's paged attention against the JAX package, on the CPU.

The same numpy inputs go through ``repro.nn.attn_backend._attend_jnp``
under ``jax.jit`` (the oracle the Pallas kernel is held to bitwise) and the
port's plain version ``kernels.ref.paged_attention_ref`` (the version the
CUDA kernel is held to on the card), over the case grid of the JAX
package's own kernel tests.  Tolerances: float32 pools ``rtol = atol =
1e-5`` (float32 sums in other orders); bf16 queries one bf16 ulp of the
output's largest magnitude (the same roundings, after float32 sums that
may differ in the last bit).
``quantize_kv_int8``, ``position_mask`` and the page write are bitwise.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention_hbm_bytes as jax_hbm_bytes)
from repro.nn import attention as JA  # noqa: E402
from repro.nn import attn_backend as JAB  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention_hbm_bytes, visible_rows)
from repro_torch.kernels.ref import paged_attention_ref  # noqa: E402
from repro_torch.nn import attention as TA  # noqa: E402
from repro_torch.nn import attn_backend as TAB  # noqa: E402
from repro_torch.nn.common import rope_cos_sin  # noqa: E402
from test_torch_cuda import _overwrite_past  # noqa: E402

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _case(seed, B, C, H, KV, hd, page, n_ps, dtype, quantized, past=False):
    """Numpy q, pools filled everywhere with garbage, a shuffled block
    table (optionally with entries past the pool) and positions."""
    rng = np.random.default_rng(seed)
    N = B * n_ps
    q = rng.normal(0, 1, (B, C, H, hd)).astype(np.float32)
    tbl = rng.permutation(N).reshape(B, n_ps).astype(np.int32)
    if past:
        tbl[0, -1] = N + 2
    pos0 = rng.integers(0, n_ps * page - C + 1, B)
    pos = (pos0[:, None] + np.arange(C)[None]).astype(np.int32)
    shape = (N, page, KV, hd)
    if quantized:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, shape[:-1] + (1,)).astype(
            np.float32) for _ in range(2))
    else:
        k, v = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(2))
        ks = vs = None
    return q, k, v, ks, vs, tbl, pos


def _both(case, dtype, H, hd, window):
    """(JAX jnp oracle under jit, port plain version) as float32 numpy."""
    q, k, v, ks, vs, tbl, pos = case
    qdt = "bf16" if dtype == "bf16" else "f32"
    pool_j = jnp.int8 if dtype == "int8" else _JDT[qdt]
    pool_t = torch.int8 if dtype == "int8" else _TDT[qdt]
    kv = JAB.PagedKV(
        k=jnp.asarray(k, pool_j), v=jnp.asarray(v, pool_j),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
        block_tbl=jnp.asarray(tbl), pos=jnp.asarray(pos))
    fn = jax.jit(functools.partial(JAB._attend_jnp, n_heads=H, head_dim=hd,
                                   window=jnp.int32(window)))
    want = np.asarray(fn(jnp.asarray(q, _JDT[qdt]), kv).astype(jnp.float32))
    opt = (lambda a: None if a is None else torch.as_tensor(a))
    got = paged_attention_ref(
        torch.as_tensor(q).to(_TDT[qdt]), torch.as_tensor(k).to(pool_t),
        torch.as_tensor(v).to(pool_t), torch.as_tensor(tbl),
        torch.as_tensor(pos), window, opt(ks), opt(vs))
    assert got.dtype == _TDT[qdt] and got.shape == q.shape
    return want, got.float().numpy()


def _bf16_ulp(x: np.ndarray) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("page,n_ps", [(4, 3), (8, 2)])
@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 1)])
def test_paged_attention_ref_matches_jax_fp32(page, n_ps, C, H, KV):
    case = _case(page * 100 + C * 10 + H, 3, C, H, KV, 8, page, n_ps,
                 "f32", False, past=True)
    want, got = _both(case, "f32", H, 8, page)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 4, 13])
def test_paged_attention_ref_matches_jax_bf16_windows(window):
    case = _case(window + 1, 2, 3, 4, 2, 16, 8, 2, "bf16", False)
    want, got = _both(case, "bf16", 4, 16, window)
    np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_ulp(want))


@pytest.mark.parametrize("C", [1, 6])
@pytest.mark.parametrize("qdtype", ["f32", "bf16"])
def test_paged_attention_ref_matches_jax_int8(C, qdtype):
    """int8 pools, dequantized in q's type as the oracle does."""
    case = _case(C, 2, C, 4, 2, 8, 4, 3, "int8", True)
    q, k, v, ks, vs, tbl, pos = case
    if qdtype == "bf16":  # int8 pools under bf16 queries
        kv = JAB.PagedKV(k=jnp.asarray(k), v=jnp.asarray(v),
                         k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                         block_tbl=jnp.asarray(tbl), pos=jnp.asarray(pos))
        fn = jax.jit(functools.partial(JAB._attend_jnp, n_heads=4,
                                       head_dim=8, window=jnp.int32(0)))
        want = np.asarray(fn(jnp.asarray(q, jnp.bfloat16), kv).astype(
            jnp.float32))
        got = paged_attention_ref(
            torch.as_tensor(q).to(torch.bfloat16), torch.as_tensor(k),
            torch.as_tensor(v), torch.as_tensor(tbl), torch.as_tensor(pos),
            0, torch.as_tensor(ks), torch.as_tensor(vs)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_ulp(want))
    else:
        want, got = _both(case, "int8", 4, 8, 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_quantize_kv_int8_bitwise():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (4, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector takes the 1e-8 floor
    x[1, 0, 0, :4] = [127.5, -63.5, 0.5, 1.5]  # ties round half to even
    for dt_j, dt_t in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
        qj, sj = JA.quantize_kv_int8(jnp.asarray(x, dt_j))
        qt, st = TA.quantize_kv_int8(torch.as_tensor(x).to(dt_t))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("window", [0, 1, 4, 13])
def test_position_mask_bitwise(window):
    rng = np.random.default_rng(window)
    qp = rng.integers(0, 40, (3, 5)).astype(np.int32)
    kp = np.tile(np.arange(40, dtype=np.int32), (3, 1))
    for causal in (True, False):
        want = np.asarray(JAB.position_mask(jnp.asarray(qp), jnp.asarray(kp),
                                            jnp.int32(window), causal))
        got = TAB.position_mask(torch.as_tensor(qp), torch.as_tensor(kp),
                                window, causal).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_repeat_kv_matches_jax():
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(
        TAB.repeat_kv(torch.as_tensor(x), 6).numpy(),
        np.asarray(JAB.repeat_kv(jnp.asarray(x), 6)))


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_write_drops_past_the_pool_bitwise(quantized):
    """The port's in-place page write equals the JAX ``.at[].set(mode=
    "drop")`` on the same K/V: rows with an id past the pool drop."""
    rng = np.random.default_rng(3)
    N, page, KV, hd, B, C = 6, 4, 2, 8, 2, 3
    k = rng.normal(0, 1, (B, C, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, C, KV, hd)).astype(np.float32)
    ids = np.array([[1, 1, N], [4, N, N]], np.int32)
    off = np.array([[2, 3, 0], [0, 1, 2]], np.int32)
    if quantized:
        zj = lambda dt, s: jnp.zeros(s, dt)  # noqa: E731
        jkv = JAB.PagedKV(zj(jnp.int8, (N, page, KV, hd)),
                          zj(jnp.int8, (N, page, KV, hd)),
                          zj(jnp.float32, (N, page, KV, 1)),
                          zj(jnp.float32, (N, page, KV, 1)))
        tkv = TAB.PagedKV(*(torch.zeros(t.shape, dtype=torch.int8
                                        if t.dtype == jnp.int8
                                        else torch.float32)
                            for t in (jkv.k, jkv.v, jkv.k_scale, jkv.v_scale)))
    else:
        jkv = JAB.PagedKV(jnp.zeros((N, page, KV, hd), jnp.bfloat16),
                          jnp.zeros((N, page, KV, hd), jnp.bfloat16))
        tkv = TAB.PagedKV(torch.zeros((N, page, KV, hd), dtype=torch.bfloat16),
                          torch.zeros((N, page, KV, hd), dtype=torch.bfloat16))
    jkv = JA._paged_write(jkv.with_view(None, None, jnp.asarray(ids),
                                        jnp.asarray(off)),
                          jnp.asarray(k, jnp.bfloat16),
                          jnp.asarray(v, jnp.bfloat16))
    tids = torch.as_tensor(ids)
    toff = torch.as_tensor(off)
    tkv = TA._paged_write(tkv.with_view(None, None, tids, toff,
                                        TA.write_rows(tids, toff, N, page)),
                          torch.as_tensor(k).to(torch.bfloat16),
                          torch.as_tensor(v).to(torch.bfloat16))
    for a, b in zip(tkv.pools(), (jkv.k, jkv.v) + (
            (jkv.k_scale, jkv.v_scale) if quantized else ())):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))
    assert tkv.k.float().abs().sum() > 0


def test_paged_block_matches_jax_end_to_end():
    """``paged_decode_attention_block`` (projection, write, attend, output
    projection) on the JAX package's float32 weights, f32 activations."""
    rng = np.random.default_rng(5)
    B, H, KV, hd, page, n_ps, C = 2, 4, 2, 16, 4, 3, 2
    D, N = H * hd, B * n_ps
    key = jax.random.PRNGKey(1)
    pj = JA.init_attention(key, D, H, KV, hd, qkv_bias=True)
    pt = {k: torch.tensor(np.asarray(a)) for k, a in pj.items()}
    x = rng.normal(0, 1, (B, C, D)).astype(np.float32)
    tbl = rng.permutation(N).reshape(B, n_ps).astype(np.int32)
    pos = np.array([[3, 4], [7, 8]], np.int32)
    ids = np.take_along_axis(tbl, pos // page, 1).astype(np.int32)
    view = (tbl, pos, ids, pos % page)
    jkv = JAB.PagedKV(jnp.zeros((N, page, KV, hd)), jnp.zeros((N, page, KV, hd)))
    tkv = TAB.PagedKV(torch.zeros((N, page, KV, hd)),
                      torch.zeros((N, page, KV, hd)))
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, window=0,
              qk_norm=False, norm_eps=1e-6)
    oj, jkv = JA.paged_decode_attention_block(
        pj, jnp.asarray(x), jkv.with_view(*map(jnp.asarray, view)),
        impl="jnp", rope_theta=1e4, **kw)
    tview = tuple(map(torch.as_tensor, view))
    ot, tkv = TA.paged_decode_attention_block(
        pt, torch.as_tensor(x),
        tkv.with_view(*tview, TA.write_rows(tview[2], tview[3], N, page)),
        rope=rope_cos_sin(tview[1], hd, 1e4), impl="auto", **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k), rtol=1e-5,
                               atol=1e-5)


def test_attention_registry_is_the_ports_own():
    """``auto`` is the kernel on a CUDA device and the plain version on the
    CPU; the JAX package's names mean nothing here."""
    assert TAB.available() == ("cuda", "torch")
    assert TAB.valid_impls() == ("auto", "cuda", "torch")
    assert TAB.resolve("auto", "cpu") == "torch"
    assert TAB.resolve("auto", torch.device("cuda", 0)) == "cuda"
    assert TAB.resolve("torch", "cuda") == "torch"
    for name in ("jnp", "pallas", "triton"):
        with pytest.raises(ValueError):
            TAB.resolve(name, "cpu")
        with pytest.raises(KeyError):
            TAB.get(name)
    with pytest.raises(ValueError, match="device"):
        TAB.resolve("auto")
    q = torch.zeros((1, 1, 2, 8))
    with pytest.raises(ValueError, match="cuda"):
        TAB.get("cuda")(q, None, n_heads=2, head_dim=8, window=0)


def test_kernel_wrapper_takes_the_plain_version_on_cpu():
    case = _case(9, 2, 2, 4, 2, 16, 4, 3, "bf16", False, past=True)
    q, k, v, _, _, tbl, pos = case
    args = (torch.as_tensor(q).to(torch.bfloat16),
            torch.as_tensor(k).to(torch.bfloat16),
            torch.as_tensor(v).to(torch.bfloat16), torch.as_tensor(tbl),
            torch.as_tensor(pos), 3)
    ops.reset_launch_counts()
    assert torch.equal(ops.paged_attention(*args), paged_attention_ref(*args))
    assert ops.launch_counts()["paged_attention"] == 0


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("C", [1, 8])
def test_paged_attention_byte_model(quantized, C):
    """The kernel reads every mapped page of every slot once, as the Pallas
    kernel DMAs them: the JAX package's byte model less its window scalar,
    which this kernel takes as an argument.  At the serve decode shape (16
    slots, 64 pages of 16, bf16) that is the 16.8 MB of K and V."""
    kw = dict(B=16, C=C, H=12, KV=2, hd=128, n_ps=64, page=16,
              pool_bytes=1 if quantized else 2, quantized=quantized,
              act_bytes=2)
    got = paged_attention_hbm_bytes(**kw)
    assert got == jax_hbm_bytes(**kw) - 4
    kv = 2 * 16 * 64 * 16 * 2 * 128 * (1 if quantized else 2)
    assert kv == (8_388_608 if quantized else 16_777_216)
    assert got == (kv + (2 * 16 * 64 * 16 * 2 * 4 if quantized else 0)
                   + 2 * 16 * C * 12 * 128 * 2 + (16 * 64 + 16 * C) * 4)


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("window", [0, 13])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_plain_paged_attention_ignores_rows_past_each_position(C, window,
                                                               dtype):
    """What the kernel's page skipping relies on: the plain version (the
    oracle's op sequence) is bitwise unchanged when every K/V row past each
    slot's largest position holds other finite values.  Each such row's
    score is masked to -2^30, so it adds exp(-2^30 + x - max) = +0.0."""
    quantized = dtype == "int8"
    q, k, v, ks, vs, tbl, pos = _case(C * 7 + window, 3, C, 4, 2, 16, 8, 6,
                                      dtype, quantized, past=True)
    pos = pos - pos[:, :1] + np.array([[0], [9], [30]], np.int32)
    qdt = torch.bfloat16
    pool_dt = torch.int8 if quantized else torch.bfloat16
    args = [torch.as_tensor(k).to(pool_dt), torch.as_tensor(v).to(pool_dt)]
    if quantized:
        args += [torch.as_tensor(ks), torch.as_tensor(vs)]
    qt, tt, pt = (torch.as_tensor(q).to(qdt), torch.as_tensor(tbl),
                  torch.as_tensor(pos))

    def attend(pools):
        k_, v_, *sc = pools
        return paged_attention_ref(qt, k_, v_, tt, pt, window,
                                   *(sc or [None, None]))

    want = attend(args)
    changed = _overwrite_past(C, tt, pt, *args)
    assert not torch.equal(changed[0], args[0])
    assert torch.equal(attend(changed), want)


def test_paged_attention_byte_model_counts_visible_rows():
    """With positions, the kernel's bytes are each slot's visible range of
    K/V rows (a slot with a row that sees nothing reads the whole axis)."""
    S = 4 * 16
    pos = np.array([[0, 1], [9, 10], [-1, 30], [63, 70]])
    np.testing.assert_array_equal(visible_rows(pos, 0, S), [2, 11, S, 64])
    # with a window, position 70 sees nothing in [0, 64): the whole axis
    np.testing.assert_array_equal(visible_rows(pos, 5, S), [2, 6, S, S])
    kw = dict(B=4, C=2, H=4, KV=2, hd=8, n_ps=4, page=16, act_bytes=2)
    full = paged_attention_hbm_bytes(pool_bytes=2, quantized=False, **kw)
    got = paged_attention_hbm_bytes(pool_bytes=2, quantized=False,
                                    positions=pos, window=5, **kw)
    rows = 2 + 6 + S + S
    assert full - got == 2 * (4 * S - rows) * 2 * 8 * 2
    i8 = paged_attention_hbm_bytes(pool_bytes=1, quantized=True,
                                   positions=pos, window=5, **kw)
    assert i8 == rows * 2 * (2 * 8 + 2 * 4) + 2 * 4 * 2 * 4 * 8 * 2 + (
        4 * 4 + 4 * 2) * 4
