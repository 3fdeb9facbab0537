"""The port's token sampling against the JAX package, on the CPU.

``hash_u32`` and ``uniform`` are integer paths: bitwise equal.  Gumbel
noise goes through ``log`` twice, where the two frameworks differ by up to
one float32 ulp, so ``sample_tokens`` and ``filter_logits`` are held to
give identical tokens and identical keep masks on identical logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import sampling as JS  # noqa: E402
from repro_torch.arch import sampling as TS  # noqa: E402

SEEDS = np.array([0, 1, 7, 12345, 0x7FFFFFFF, -1, -(2**31)], np.int32)


@pytest.mark.parametrize("salt", [0, 1, 2])
def test_hash_u32_and_uniform_bitwise(salt):
    pos = np.array([0, 1, 5, 31, 1000, 2**20, 0x7FFFFFFF], np.int32)
    lanes = np.arange(0, 152064, 97, dtype=np.uint32)
    js, jp, jl = (jnp.asarray(SEEDS)[:, None], jnp.asarray(pos)[:, None],
                  jnp.asarray(lanes)[None])
    ts, tp = torch.as_tensor(SEEDS)[:, None], torch.as_tensor(pos)[:, None]
    tl = torch.as_tensor(lanes.astype(np.int64))[None]
    h = TS.hash_u32(ts, tp, salt, tl)
    assert h.dtype == torch.int64 and int(h.min()) >= 0 and \
        int(h.max()) < 2**32
    np.testing.assert_array_equal(
        h.numpy(), np.asarray(JS.hash_u32(js, jp, salt, jl)).astype(np.int64))
    u = TS.uniform(ts, tp, salt, tl)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(),
                                  np.asarray(JS.uniform(js, jp, salt, jl)))


def test_hash_u32_python_scalars():
    for s in (0, 0x7FFFFFFF, 123):
        assert int(TS.hash_u32(s, 3, 1, 9)) == int(JS.hash_u32(s, 3, 1, 9))


def _logits(seed, rows=6, V=512):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (rows, V)).astype(np.float32)
    x[0, 10] = x[0, 20] = x[0].max() + 1.0  # an argmax tie: first index
    return x


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (40, 1.0), (0, 0.9),
                                         (40, 0.8), (1, 1.0)])
def test_filter_logits_same_keep_set(top_k, top_p):
    x = _logits(top_k + int(top_p * 10))
    want = np.isfinite(np.asarray(JS.filter_logits(jnp.asarray(x), top_k,
                                                   top_p)))
    got = torch.isfinite(TS.filter_logits(torch.as_tensor(x), top_k,
                                          top_p)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (1.0, 0, 1.0), (2.0, 40, 1.0), (0.7, 0, 0.9),
    (1.3, 50, 0.95)])
def test_sample_tokens_identical_on_identical_logits(temperature, top_k,
                                                     top_p):
    x = _logits(int(temperature * 10), rows=64)
    seeds = np.arange(64, dtype=np.int32) * 7919 - 100
    gidx = np.arange(64, dtype=np.int32) % 9
    want = np.asarray(JS.sample_tokens(jnp.asarray(x), jnp.asarray(seeds),
                                       jnp.asarray(gidx), temperature, top_k,
                                       top_p))
    got = TS.sample_tokens(torch.as_tensor(x), torch.as_tensor(seeds),
                           torch.as_tensor(gidx), temperature, top_k, top_p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if temperature == 0.0:
        assert want[0] == 10


def test_token_probs_close():
    x = _logits(3)
    np.testing.assert_allclose(
        TS.token_probs(torch.as_tensor(x), 0.8, 20, 0.9).numpy(),
        np.asarray(JS.token_probs(jnp.asarray(x), 0.8, 20, 0.9)),
        rtol=1e-5, atol=1e-7)
