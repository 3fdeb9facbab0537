"""The port's plain kernel versions against the JAX package's, bitwise.

Same inputs (numpy, from a seed) through ``repro.kernels.ops`` with the
``"jnp"`` oracle and with ``"pallas"`` (interpret mode on the CPU) and
through ``repro_torch.kernels`` on CPU tensors, at the sweep shapes and
edge cases of ``tests/test_kernels.py``.  The input makers live in
``test_torch_cuda.py``, which the card runs without jax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.tables import key_layout, pack_codes  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_torch_cuda import (  # noqa: E402
    _bnn_case,
    _bucketize_case,
    _fused_case,
    _lb_case,
    _lb_out_of_range_case,
    _match_case,
    _t,
    _unsorted_bucketize_case,
)

JAX_BACKENDS = ("jnp", "pallas")


@pytest.mark.parametrize("B", [1, 7, 256, 1000])
@pytest.mark.parametrize("F,T", [(1, 1), (5, 9), (8, 32)])
def test_bucketize_equals_jax(B, F, T):
    vals, thr = _bucketize_case(B * 100 + F * 10 + T, B, F, T)
    got = ref.bucketize_ref(_t(vals), _t(thr)).numpy()
    assert np.array_equal(got, ops.bucketize(_t(vals), _t(thr)).numpy())
    for backend in JAX_BACKENDS:
        want = np.asarray(jops.bucketize(vals, thr, backend=backend))
        np.testing.assert_array_equal(got, want)


def test_bucketize_int32_max_against_padding():
    vals, thr = _bucketize_case(3, 9, 2, 8, int32_max=True)
    got = ref.bucketize_ref(_t(vals), _t(thr)).numpy()
    assert got[0, 0] == 8  # every padded column counts at v == INT32_MAX
    for backend in JAX_BACKENDS:
        np.testing.assert_array_equal(
            got, np.asarray(jops.bucketize(vals, thr, backend=backend)))


@pytest.mark.parametrize("B,T", [(40, 3), (300, 9), (7, 32)])
def test_bucketize_any_row_order_equals_jax(B, T):
    """The op's contract is the JAX package's for any row: the count of
    thresholds <= v, on ``[5, 3, INT32_MAX]``, a reversed row and a row
    with ties, against its oracle and its Pallas kernel (interpret)."""
    from repro.kernels.bucketize import bucketize_pallas
    from repro.kernels.ref import bucketize_ref as jax_bucketize_ref

    vals, thr = _unsorted_bucketize_case(T, B, T)
    got = ops.bucketize(_t(vals), _t(thr)).numpy()
    want = (vals[:, :, None] >= thr[None].astype(np.int64)).sum(-1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_bucketize_ref(vals, thr)))
    np.testing.assert_array_equal(
        got, np.asarray(bucketize_pallas(vals, thr, interpret=True)))


@pytest.mark.parametrize("B,F,V,K", [(1, 5, 2, 1), (100, 5, 64, 6),
                                     (257, 3, 256, 16)])
def test_lb_lookup_out_of_range_codes_equal_pallas(B, F, V, K):
    """A code outside [0, V) adds 0 to every output, as in the Pallas
    kernel (a one-hot product); no wrap and no raise."""
    from repro.kernels.lb_lookup import lb_lookup_pallas

    codes, luts = _lb_out_of_range_case(B + V, B, F, V, K)
    got = ops.lb_lookup(_t(codes), _t(luts))
    assert torch.equal(got, ref.lb_lookup_ref(_t(codes), _t(luts)))
    want = np.asarray(lb_lookup_pallas(codes, luts, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    valid = (codes >= 0) & (codes < V)
    manual = np.zeros((B, K), np.int64)
    for f in range(F):
        manual += np.where(valid[:, f, None],
                           luts[f][np.clip(codes[:, f], 0, V - 1)], 0)
    np.testing.assert_array_equal(got.numpy(), manual.astype(np.int32))


@pytest.mark.parametrize("B,N,W", [(1, 1, 1), (64, 100, 1), (200, 700, 2),
                                   (33, 513, 3)])
def test_ternary_match_equals_jax(B, N, W):
    keys, values, masks, pa = _match_case(B + N + W, B, N, W)
    args = (_t(keys), _t(values), _t(masks), _t(pa), 254)
    got = ref.ternary_match_ref(*args).numpy()
    assert np.array_equal(got, ops.ternary_match(*args).numpy())
    for backend in JAX_BACKENDS:
        want = np.asarray(jops.ternary_match(keys, values, masks, pa, 254,
                                             backend))
        np.testing.assert_array_equal(got, want)


def test_ternary_priority_and_default():
    values = np.array([[0b1000], [0b1000]], np.uint32)
    pa = np.array([0 * 256 + 7, 1 * 256 + 9], np.int32)
    keys = np.array([[0b1010], [0b0001]], np.uint32)  # overlap hit; no hit
    got = ops.ternary_match(_t(keys), _t(values), _t(values), _t(pa), 123)
    assert got.tolist() == [9, 123]
    for backend in JAX_BACKENDS:
        want = np.asarray(jops.ternary_match(keys, values, values, pa, 123,
                                             backend))
        np.testing.assert_array_equal(got.numpy(), want)
    empty = np.zeros((0, 1), np.uint32)
    out = ops.ternary_match(_t(keys), _t(empty), _t(empty),
                            _t(np.zeros(0, np.int32)), 42)
    assert out.tolist() == [42, 42]


@pytest.mark.parametrize("B,F,T,N,identity", [(1, 5, 12, 40, False),
                                              (300, 5, 28, 200, False),
                                              (64, 5, 1, 128, True)])
def test_fused_eb_equals_jax(B, F, T, N, identity):
    vals, thr, rv, rm, pa, layout, W = _fused_case(B + T + N, B, F, T, N,
                                                   identity)
    lay = torch.as_tensor(layout, dtype=torch.int32)
    got = ref.fused_eb_ref(_t(vals), _t(thr), _t(rv), _t(rm), _t(pa), lay, 77,
                           identity).numpy()
    assert np.array_equal(got, ops.fused_eb_match(
        _t(vals), _t(thr), _t(rv), _t(rm), _t(pa), lay, 77, identity).numpy())
    for backend in ("jnp", "pallas"):
        want = np.asarray(jops.fused_eb_match(vals, thr, rv, rm, pa, layout, W,
                                              77, backend=backend,
                                              identity=identity))
        np.testing.assert_array_equal(got, want)


def test_pack_codes_equals_numpy_reference():
    rng = np.random.default_rng(7)
    widths = [3, 8, 1, 12, 9, 32, 5]
    codes = np.stack([rng.integers(0, 2**w, 50) for w in widths], axis=1)
    layout = key_layout(widths)
    W = max(w for w, _, _ in layout) + 1
    got = ref.pack_codes_ref(torch.as_tensor(codes.astype(np.int64)), layout, W)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  pack_codes(codes, widths))


@pytest.mark.parametrize("B,F,V,K,action_bits", [(1, 1, 2, 1, 16),
                                                 (100, 5, 64, 6, 16),
                                                 (257, 3, 256, 16, 16),
                                                 (300, 5, 256, 3, 24)])
def test_lb_lookup_equals_jax(B, F, V, K, action_bits):
    codes, luts = _lb_case(B + K, B, F, V, K, lim=2 ** (action_bits - 1))
    got = ref.lb_lookup_ref(_t(codes), _t(luts))
    assert got.dtype == torch.int32
    assert torch.equal(got, ops.lb_lookup(_t(codes), _t(luts)))
    for backend in JAX_BACKENDS:
        want = np.asarray(jops.lb_lookup(codes, luts, backend=backend,
                                         action_bits=action_bits))
        np.testing.assert_array_equal(got.numpy(), want)


def test_lb_lookup_wraps_as_int32():
    """Sums past int32 wrap in both packages (the JAX sum is int32)."""
    codes = np.zeros((2, 3), np.int32)
    luts = np.full((3, 1, 1), 2**30 + 7, np.int32)
    got = ref.lb_lookup_ref(_t(codes), _t(luts)).numpy()
    want = np.asarray(jops.lb_lookup(codes, luts, backend="jnp"))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == np.int64(3 * (2**30 + 7)).astype(np.int32)


@pytest.mark.parametrize("B,n_in,n_out", [(1, 1, 1), (64, 40, 16),
                                          (100, 100, 3), (17, 64, 33)])
def test_bnn_popcount_and_forward_equal_jax(B, n_in, n_out):
    xb, w, xp, wp = _bnn_case(B + n_in + n_out, B, n_in, n_out)
    x, wt = _t(xp), _t(wp)
    counts = ref.bnn_popcount_matmul_ref(x, wt)
    assert counts.dtype == torch.int32
    assert torch.equal(counts, ops.bnn_popcount_matmul(x, wt))
    got = ops.bnn_forward(x, [(wt, n_in)]).numpy()
    np.testing.assert_array_equal(got, xb @ w.T)
    for backend in JAX_BACKENDS:
        np.testing.assert_array_equal(counts.numpy(), np.asarray(
            jops.bnn_popcount_matmul(xp, wp, backend=backend)))
        np.testing.assert_array_equal(got, np.asarray(
            jops.bnn_forward(xp, [(wp, n_in)], backend)))
    np.testing.assert_array_equal(
        ref.pack_bits_ref(torch.as_tensor(xb > 0)).numpy().view(np.uint32),
        np.asarray(jops.pack_bits_jnp(np.asarray(xb > 0, np.uint32))))


def test_bnn_two_layer_forward_equals_jax():
    B, n_in, h, k = 32, 24, 16, 3
    xb, w1, xp, w1p = _bnn_case(5, B, n_in, h)
    _, w2, _, w2p = _bnn_case(6, 1, h, k)
    expect = np.where(xb @ w1.T >= 0, 1, -1) @ w2.T
    layers = [(_t(w1p), n_in), (_t(w2p), h)]
    for plain in (False, True):
        got = ops.bnn_forward(_t(xp), layers, plain=plain).numpy()
        np.testing.assert_array_equal(got, expect)
    for backend in JAX_BACKENDS:
        want = jops.bnn_forward(xp, [(w1p, n_in), (w2p, h)], backend)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("word,bits", [(0, 0), (0xFFFFFFFF, 32),
                                       (0x80000000, 1), (0x7FFFFFFF, 31)])
def test_swar_popcount_edges(word, bits):
    w = _t(np.array([[word]], np.uint32))
    assert ref.popcount32(w).item() == bits
    ones = np.array([[0xFFFFFFFF]], np.uint32)  # ~(x ^ ~0) == x
    got = ref.bnn_popcount_matmul_ref(w, _t(ones)).item()
    want = np.asarray(jops.bnn_popcount_matmul(
        np.array([[word]], np.uint32), ones, backend="jnp"))
    assert got == bits == want.item()


def test_pack_bits_sets_bit_31_without_overflow():
    bits = torch.zeros((2, 40), dtype=torch.int32)
    bits[0, 31] = 1
    bits[1, :32] = 1
    words = ref.pack_bits_ref(bits).numpy().view(np.uint32)
    np.testing.assert_array_equal(words, [[0x80000000, 0], [0xFFFFFFFF, 0]])
    want = jops.pack_bits_jnp(bits.numpy().astype(np.uint32))
    np.testing.assert_array_equal(words, np.asarray(want))


# ------------------------------------- bnn_popcount_matmul's fused modes
def _jax_pack_input(x, in_bits):
    """The JAX package's DM-BNN input packing (``DMBnn.make_jax_fn``)."""
    import jax.numpy as jnp

    shifts = jnp.arange(in_bits, dtype=jnp.int32)
    bits = ((jnp.asarray(x, jnp.int32)[..., None] >> shifts) & 1).reshape(
        x.shape[0], -1)
    return np.asarray(jops.pack_bits_jnp(bits.astype(jnp.uint32)))


@pytest.mark.parametrize("in_bits,F", [(1, 5), (3, 7), (8, 5), (13, 5),
                                       (32, 3)])
def test_bnn_input_prologue_equals_jax_pack(in_bits, F):
    """Feature values above 2^in_bits and negative ones keep their low
    in_bits bits (two's complement) on both sides."""
    rng = np.random.default_rng(in_bits * 10 + F)
    x = rng.integers(-2**31, 2**31, (50, F)).astype(np.int32)
    x[0] = 2**31 - 1
    x[1] = -1
    x[2] = 2**in_bits % 2**31  # just past the field
    want = _jax_pack_input(x, in_bits)
    words = ref.bnn_pack_input_ref(_t(x), in_bits)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    W = want.shape[1]
    wp = rng.integers(0, 2**32, (7, W), dtype=np.uint32)
    got = ops.bnn_popcount_matmul(_t(x), _t(wp), in_bits=in_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.bnn_popcount_matmul(want, wp, backend="jnp")))


# n_in -> (in_bits, F) of a feature input with that many bits
_FEATURES_OF = {1: (1, 1), 40: (8, 5), 100: (10, 10)}


@pytest.mark.parametrize("features", [False, True])
@pytest.mark.parametrize("n_out", [1, 33, 48])
@pytest.mark.parametrize("n_in", [1, 40, 100])
def test_bnn_epilogues_equal_jax(n_in, n_out, features):
    """The hidden epilogue's sign words, the score epilogue and a two-layer
    forward (input packed, or packed by the prologue) against
    ``jops.bnn_forward``'s arithmetic."""
    xb, w1, xp, w1p = _bnn_case(n_in * 100 + n_out, 40, n_in, n_out)
    _, w2, _, w2p = _bnn_case(n_out + 7, 1, n_out, 3)
    kw = {}
    x = _t(xp)
    if features:
        in_bits, F = _FEATURES_OF[n_in]
        rng = np.random.default_rng(n_out)
        feats = rng.integers(0, 2**in_bits, (40, F)).astype(np.int32)
        feats[::3] += rng.integers(1, 4, (14, 1)).astype(np.int32) << in_bits
        xp = _jax_pack_input(feats, in_bits)
        xb = np.where(np.unpackbits(xp.view(np.uint8), axis=1,
                                    bitorder="little")[:, :n_in] > 0, 1, -1)
        x, kw = _t(feats), {"in_bits": in_bits}
    dot = np.asarray(jops.bnn_forward(xp, [(w1p, n_in)], "jnp"))
    np.testing.assert_array_equal(dot, xb @ w1.T)
    signs = np.asarray(jops.pack_bits_jnp((dot >= 0).astype(np.uint32)))
    got = ops.bnn_popcount_matmul(x, _t(w1p), epilogue="sign", n_in=n_in, **kw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), signs)
    got = ops.bnn_popcount_matmul(x, _t(w1p), epilogue="score", n_in=n_in, **kw)
    np.testing.assert_array_equal(got.numpy(), dot)
    layers = [(_t(w1p), n_in), (_t(w2p), n_out)]
    for backend in JAX_BACKENDS:
        want = np.asarray(jops.bnn_forward(xp, [(w1p, n_in), (w2p, n_out)],
                                           backend))
        for plain in (False, True):
            got = ops.bnn_forward(x, layers, plain=plain,
                                  in_bits=kw.get("in_bits", 0))
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [{"epilogue": "relu"}, {"in_bits": 33},
                                {"in_bits": -1}])
def test_bnn_popcount_matmul_rejects_bad_modes(kw):
    x = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.bnn_popcount_matmul(x, x, **kw)
