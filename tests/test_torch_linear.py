"""The serve step's products in the port (``ops.linear``, plain version
``ref.linear_ref``) against the JAX package, on the CPU.

``ref.linear_ref`` is the expression the port used before the kernel:
``x @ w`` in bf16, and for the LM head the float32 product of the bf16
values.  Against JAX's ``jnp.dot(..., preferred_element_type=float32)``
(and its bf16 dot) on the same bf16 inputs it is held elementwise within
``test_torch_cuda.linear_limit``: both accumulate the exact bf16 products
in float32, in orders that differ by at most 2 K 2^-24 sum|x||w|, plus
one bf16 ulp for a bf16 output.  The plain bf16 products' rows are
bitwise invariant to the other rows; the kernel's own invariance (bf16
and float32) is held on the card (``test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.arch import model as TM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_torch_cuda import (LINEAR_SHAPES, _linear_case,  # noqa: E402
                             linear_limit)
from test_torch_serve import CFG, both  # noqa: E402,F401

# the CPU-sized shapes of LINEAR_SHAPES (the smoke config's and the odd
# one) plus qwen2-1.5b's wk / wv
CPU_SHAPES = [s for s in LINEAR_SHAPES if s[0] * s[1] <= 1536 * 256]


def _kernel_module():
    import sys
    return sys.modules["repro_torch.kernels.linear"]


@pytest.mark.parametrize("K,N,f32", CPU_SHAPES)
@pytest.mark.parametrize("M", [1, 16, 48])
def test_plain_linear_equals_jax_dot(K, N, f32, M):
    xn, wn = _linear_case(M + K + N, M, K, N)
    x, w = torch.as_tensor(xn).bfloat16(), torch.as_tensor(wn).bfloat16()
    got = ref.linear_ref(x, w, torch.float32 if f32 else None)
    assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
    want = jnp.dot(jnp.asarray(xn, jnp.bfloat16), jnp.asarray(wn, jnp.bfloat16),
                   preferred_element_type=jnp.float32 if f32 else None)
    want = torch.as_tensor(np.asarray(want.astype(jnp.float32)))
    lim = linear_limit(x, w, want, f32)
    assert ((got.float() - want).abs() <= lim).all()


@pytest.mark.parametrize("K,N", [(K, N) for K, N, f32 in CPU_SHAPES
                                 if not f32])
def test_plain_bf16_linear_rows_are_invariant(K, N):
    """Bitwise: each row of the plain bf16 product is the same whatever M
    and wherever the row sits."""
    x, w = (torch.as_tensor(a).bfloat16() for a in _linear_case(K, 48, K, N))
    full = ref.linear_ref(x, w)
    for M in (1, 3, 16, 48):
        for o in (0, 48 - M):
            assert torch.equal(ref.linear_ref(x[o:o + M], w), full[o:o + M])


def test_ops_linear_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version, launches nothing, and keeps
    the leading dims of ``x``."""
    x, w = (torch.as_tensor(a).bfloat16() for a in _linear_case(1, 6, 48, 16))
    ops.reset_launch_counts()
    got = ops.linear(x.reshape(2, 3, 48), w)
    assert got.shape == (2, 3, 16)
    assert torch.equal(got.reshape(6, 16), ref.linear_ref(x, w))
    assert torch.equal(ops.linear(x, w, torch.float32),
                       x.float() @ w.float())
    assert ops.launch_counts()["linear"] == 0


def test_plan_is_a_function_of_k_and_n():
    """The K slices: multiples of 64 that cover K, S = ceil(K / KS), about
    132 blocks; the row tiles never change them."""
    lin = _kernel_module()
    for K, N, _ in LINEAR_SHAPES:
        KS, S = lin.plan(K, N)
        assert KS % lin.KC == 0 and S == -(-K // KS) and (S - 1) * KS < K
    # qwen2-1.5b: wq / wo, wk / wv, w_gate / w_up, w_down, the head
    assert lin.plan(1536, 1536) == (128, 12)
    assert lin.plan(1536, 256) == (64, 24)
    assert lin.plan(1536, 8960) == (768, 2)
    assert lin.plan(8960, 1536) == (832, 11)
    assert lin.plan(1536, 152064) == (1536, 1)
    assert [lin.row_tiles(M) for M in (1, 16, 17, 48, 64, 65, 128, 256)] == [
        1, 1, 2, 4, 4, 8, 8, 8]
    assert lin.linear_hbm_bytes(16, 1536, 152064, 4) == (
        2 * 16 * 1536 + 2 * 1536 * 152064 + 4 * 16 * 152064)


def test_every_product_of_the_step_goes_through_ops_linear(both,
                                                           monkeypatch):
    """``paged_decode_step`` makes 7 products a layer (wq, wk, wv, wo,
    w_gate, w_up, w_down) and the head, each one ``ops.linear``: the head's
    in float32, the others in bf16 on bf16 weights."""
    _, tp, _, _ = both
    calls = []
    real = ops.linear

    def spy(x, w, out_dtype=None):
        calls.append((tuple(w.shape), w.dtype, out_dtype))
        return real(x, w, out_dtype)

    monkeypatch.setattr(ops, "linear", spy)
    kv = TM.init_paged_kv(CFG, 8, 8, device="cpu")
    tbl = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    toks = torch.tensor([[5, 6, 7], [8, 9, 0]], dtype=torch.int32)
    TM.paged_decode_step(tp, kv, tbl, torch.zeros(2, dtype=torch.int32), toks,
                         torch.tensor([3, 2], dtype=torch.int32), CFG)
    assert len(calls) == 7 * CFG.n_layers + 1
    assert calls[-1] == ((CFG.d_model, CFG.vocab_padded), torch.bfloat16,
                         torch.float32)
    assert all(dt == torch.bfloat16 and od is None for _, dt, od in calls[:-1])
