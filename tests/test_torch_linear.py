"""The serve step's products in the port (``ops.linear``, plain version
``ref.linear_ref``) against the JAX package, on the CPU.

``ref.linear_ref`` is the expression the port used before the kernel:
``x @ w`` in bf16, and for the LM head the float32 product of the bf16
values.  Against JAX's ``jnp.dot(..., preferred_element_type=float32)``
(and its bf16 dot) on the same bf16 inputs it is held elementwise within
``test_torch_cuda.linear_limit``: both accumulate the exact bf16 products
in float32, in orders that differ by at most 2 K 2^-24 sum|x||w|, plus
one bf16 ulp for a bf16 output.  The plain products' rows, bf16 and
float32, are bitwise invariant to the other rows; the kernel's own
invariance and its grouped launches are held on the card
(``test_torch_cuda.py``).
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
# one) plus qwen2-1.5b's wk / wv and qwen2-moe-a2.7b's router
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
                       torch.cat([r.float() @ w.float() for r in x.split(1)]))
    assert ops.launch_counts()["linear"] == 0


def test_plain_f32_linear_rows_are_invariant():
    """Bitwise (ROADMAP §C.6): each row of the plain float32 product (the
    LM head's) is the same in a [64, K] and a [16, K] operand and alone.
    The CPU BLAS's product of all rows at once gave all 64 rows of a
    [64, 1536] x [1536, 256] product other bits than the rows alone."""
    x, w = (torch.as_tensor(a).bfloat16()
            for a in _linear_case(64, 64, 1536, 256))
    full = ref.linear_ref(x, w, torch.float32)
    assert full.dtype == torch.float32 and full.shape == (64, 256)
    for o, M in ((0, 16), (40, 16), (5, 1), (63, 1)):
        assert torch.equal(ref.linear_ref(x[o:o + M], w, torch.float32),
                           full[o:o + M]), (o, M)


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_linear_group_on_cpu_is_the_plain_version(out_dtype):
    """A CPU group is the plain version of each member, keeps the leading
    dims of ``x`` and launches nothing."""
    xn, _ = _linear_case(3, 6, 48, 8)
    x = torch.as_tensor(xn).bfloat16().reshape(2, 3, 48)
    ws = [torch.as_tensor(_linear_case(4 + i, 1, 48, n)[1]).bfloat16()
          for i, n in enumerate((16, 8, 24))]
    ops.reset_launch_counts()
    got = ops.linear_group(x, ws, out_dtype)
    assert [tuple(g.shape) for g in got] == [(2, 3, 16), (2, 3, 8),
                                             (2, 3, 24)]
    for g, w in zip(got, ws):
        assert torch.equal(g, ref.linear_ref(x, w, out_dtype))
        assert torch.equal(g, ops.linear(x, w, out_dtype))
    assert ops.launch_counts()["linear"] == 0


def test_plan_is_a_function_of_k_and_n():
    """The K slices: multiples of 64 that cover K, S = ceil(K / KS) a power
    of two up to 8 (one cluster), at least 48 blocks and at most 1600 K
    rows a slice where K allows; the row tiles never change them."""
    lin = _kernel_module()
    for K, N, _ in LINEAR_SHAPES:
        KS, S = lin.plan(K, N)
        assert KS % lin.KC == 0 and S == -(-K // KS) and (S - 1) * KS < K
        assert S in (1, 2, 4, 8)
    for K in range(8, 2049, 8):  # every K: the slices come out even
        for N in (8, 256, 1536, 8960):
            KS, S = lin.plan(K, N)
            assert S in (1, 2, 4, 8) and S == -(-K // KS) and KS % 64 == 0
    # qwen2-1.5b: wq / wo, wk / wv, w_gate / w_up, w_down, the head
    assert lin.plan(1536, 1536) == (384, 4)
    assert lin.plan(1536, 256) == (192, 8)
    assert lin.plan(1536, 8960) == (1536, 1)
    assert lin.plan(8960, 1536) == (1152, 8)
    assert lin.plan(1536, 152064) == (1536, 1)
    assert lin.plan(2048, 8960) == (1024, 2)
    assert [lin.row_tiles(M) for M in (1, 16, 17, 48, 64, 65, 128, 256)] == [
        1, 1, 1, 1, 1, 2, 2, 2]
    assert lin.linear_hbm_bytes(16, 1536, 152064, 4) == (
        2 * 16 * 1536 + 2 * 1536 * 152064 + 4 * 16 * 152064)


def test_every_product_of_the_step_goes_through_ops_linear(both,
                                                           monkeypatch):
    """``paged_decode_step`` makes 4 product launches a layer and the head:
    ``ops.linear_group`` for wq / wk / wv and for w_gate / w_up,
    ``ops.linear`` for wo and w_down, and the head in float32; the others
    in bf16 on bf16 weights."""
    _, tp, _, _ = both
    calls = []
    real, real_group = ops.linear, ops.linear_group

    def spy(x, w, out_dtype=None):
        calls.append(((tuple(w.shape),), w.dtype, out_dtype))
        return real(x, w, out_dtype)

    def spy_group(x, ws, out_dtype=None):
        assert len({w.dtype for w in ws}) == 1
        calls.append((tuple(tuple(w.shape) for w in ws), ws[0].dtype,
                      out_dtype))
        return real_group(x, ws, out_dtype)

    monkeypatch.setattr(ops, "linear", spy)
    monkeypatch.setattr(ops, "linear_group", spy_group)
    kv = TM.init_paged_kv(CFG, 8, 8, device="cpu")
    tbl = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    toks = torch.tensor([[5, 6, 7], [8, 9, 0]], dtype=torch.int32)
    TM.paged_decode_step(tp, kv, tbl, torch.zeros(2, dtype=torch.int32), toks,
                         torch.tensor([3, 2], dtype=torch.int32), CFG)
    assert len(calls) == 4 * CFG.n_layers + 1
    D, hd, F = CFG.d_model, CFG.head_dim_, CFG.d_ff
    layer = [((D, CFG.q_heads * hd), (D, CFG.n_kv_heads * hd),
              (D, CFG.n_kv_heads * hd)), ((CFG.q_heads * hd, D),),
             ((D, F), (D, F)), ((F, D),)]
    assert [c[0] for c in calls[:-1]] == layer * CFG.n_layers
    assert calls[-1] == (((D, CFG.vocab_padded),), torch.bfloat16,
                         torch.float32)
    assert all(dt == torch.bfloat16 and od is None for _, dt, od in calls[:-1])


class _FakeLib:
    """``linear_weight_map`` without a card: the map buffers stay zero."""

    def linear_weight_map(self, *args):
        return 0


@pytest.mark.parametrize("K,N,m", [(1536, 1536, 2), (1536, 256, 4),
                                   (1536, 8960, 4), (1536, 152064, 2)])
def test_plan_n_plans_a_column_slice_as_the_whole(K, N, m):
    """A column slice ``[K, N / m]`` with ``plan_n = N`` launches with the
    whole weight's ``(KS, S)`` (so its outputs are bitwise those columns
    of the whole launch), without it with its own; ``_group``'s cache key
    holds ``plan_n``, so the two are two records of one weight; a
    ``plan_n`` below the slice's N, or of another length, raises."""
    lin = _kernel_module()
    w = torch.zeros((K, N // m), dtype=torch.bfloat16)
    lin._GROUPS.clear()
    try:
        whole = lin._group(_FakeLib(), [w], lin._plan_ns([w], N))
        own = lin._group(_FakeLib(), [w], lin._plan_ns([w], None))
        assert (whole[2][0], whole[3][0]) == lin.plan(K, N)
        assert (own[2][0], own[3][0]) == lin.plan(K, N // m)
        assert whole[1][0] == own[1][0] == N // m
        keys = sorted(lin._GROUPS, key=repr)
        assert len(keys) == 2 and {k[0][-1] for k in keys} == {None, N}
    finally:
        lin._GROUPS.clear()
    assert lin._plan_ns([w, w], (N, None)) == (N, None)
    with pytest.raises(ValueError, match="less than"):
        lin._plan_ns([w], N // m - 8)
    with pytest.raises(ValueError, match="entries"):
        lin._plan_ns([w], (N, N))


def test_plan_n_on_the_cpu_is_the_plain_version():
    """On the CPU ``plan_n`` changes nothing (the plain version has no
    plan); a product with a gradient refuses it."""
    x, w = (torch.as_tensor(a).to(torch.bfloat16)
            for a in _linear_case(0, 3, 64, 32))
    assert torch.equal(ops.linear(x, w, plan_n=64), ref.linear_ref(x, w))
    assert torch.equal(ops.linear_group(x, [w, w], torch.float32,
                                        plan_n=(64, None))[1],
                       ref.linear_ref(x, w, torch.float32))
    with pytest.raises(ValueError, match="plan_n"):
        ops.linear(x, w.clone().requires_grad_(), plan_n=64)
