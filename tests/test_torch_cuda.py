"""The CUDA kernels against their plain versions, on an H100 only.

Marked ``cuda``; each test skips where there is no card.  This file
imports no jax (the machine with the card has none), so it also holds the
numpy input makers that ``test_torch_kernels.py`` shares.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.tables import key_layout  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

INT32_MAX = np.iinfo(np.int32).max


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy (uint32 words as their int32 bits) -> CPU int32 tensor."""
    a = np.ascontiguousarray(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32
                           else a.astype(np.int32))


def _bucketize_case(seed, B, F, T, int32_max=False):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2**16, (B, F)).astype(np.int32)
    thr = np.sort(rng.integers(0, 2**16, (F, T)), axis=1).astype(np.int32)
    if int32_max:  # INT32_MAX values against INT32_MAX padding
        thr[:, T // 2:] = INT32_MAX
        vals[::2, 0] = INT32_MAX
    return vals, thr


def _match_case(seed, B, N, W):
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
    masks = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
    values &= masks
    actions = rng.integers(0, 256, N).astype(np.int32)
    pa = np.arange(N, dtype=np.int32) * 256 + actions
    keys = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
    keys[: B // 2] = values[rng.integers(0, N, B // 2)]  # force hits
    return keys, values, masks, pa


def _fused_case(seed, B, F, T, N, identity):
    rng = np.random.default_rng(seed)
    if identity:
        widths = [8] * F
        vals = rng.integers(0, 256, (B, F)).astype(np.int32)
        thr = np.full((F, 1), INT32_MAX, np.int32)
    else:
        vals, thr = _bucketize_case(seed, B, F, T, int32_max=True)
        widths = [max(1, int(np.ceil(np.log2(T + 1))))] * F
    layout = key_layout(widths)
    W = max(w for w, _, _ in layout) + 1
    codes = _t(vals) if identity else ref.bucketize_ref(_t(vals), _t(thr))
    keys = ref.pack_codes_ref(codes, layout, W).numpy().view(np.uint32)
    _, rv, rm, pa = _match_case(seed + 1, 0, N, W)
    rv[: N // 2] = keys[rng.integers(0, B, N // 2)] & rm[: N // 2]
    return vals, thr, rv, rm, pa, layout, W


def _lb_case(seed, B, F, V, K, lim=2**15):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, V, (B, F)).astype(np.int32)
    luts = rng.integers(-lim, lim, (F, V, K)).astype(np.int32)
    return codes, luts


def _bnn_case(seed, B, n_in, n_out):
    """±1 inputs [B, n_in] and weights [n_out, n_in], packed LSB-first."""
    from repro_torch.core.tables import pack_bits_uint32

    rng = np.random.default_rng(seed)
    xb = rng.integers(0, 2, (B, n_in)) * 2 - 1
    w = rng.integers(0, 2, (n_out, n_in)) * 2 - 1
    return xb, w, pack_bits_uint32(xb), pack_bits_uint32(w)


# ------------------------------------------------------- on the card only
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,W", [(1, 1, 1), (200, 700, 2), (1000, 5000, 3),
                                   (300, 301, 5)])
def test_cuda_kernels_equal_plain(cuda_device, B, N, W):
    dev = cuda_device
    keys, values, masks, pa = (_t(a).to(dev) for a in _match_case(N, B, N, W))
    assert torch.equal(ops.ternary_match(keys, values, masks, pa, 254),
                       ref.ternary_match_ref(keys, values, masks, pa, 254))
    vals, thr = (_t(a).to(dev) for a in _bucketize_case(N, B, 8, 32, True))
    assert torch.equal(ops.bucketize(vals, thr), ref.bucketize_ref(vals, thr))
    case = _fused_case(N, B, 5, 28, N, False)
    args = [_t(a).to(dev) for a in case[:5]]
    lay = torch.as_tensor(case[5], dtype=torch.int32, device=dev)
    assert torch.equal(ops.fused_eb_match(*args, lay, 77),
                       ref.fused_eb_ref(*args, lay, 77))


@pytest.mark.cuda
def test_cuda_predict_paths_launch_their_kernels(cuda_device):
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset

    ds = load_dataset("unsw", n=1500)
    res = plant(PlanterConfig(model="rf", strategy="eb", size="S"),
                ds.X_train, ds.y_train)
    want = res.mapped.predict(ds.X_test)
    for backend, kernels in (("cuda", ("bucketize", "ternary_match")),
                             ("cuda_fused", ("fused_eb",))):
        fn = res.mapped.torch_predict(backend, device=cuda_device)
        ops.reset_launch_counts()
        got = fn(ds.X_test).cpu().numpy()
        counts = ops.launch_counts()
        assert all(counts[k] > 0 for k in kernels), counts
        np.testing.assert_array_equal(got, want, err_msg=backend)


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,V,K", [(1, 1, 2, 1), (100, 5, 64, 6),
                                     (257, 3, 256, 16), (3000, 8, 256, 16),
                                     (2049, 5, 256, 3)])
def test_cuda_lb_lookup_equals_plain(cuda_device, B, F, V, K):
    codes, luts = (_t(a).to(cuda_device) for a in _lb_case(B + K, B, F, V, K))
    assert torch.equal(ops.lb_lookup(codes, luts), ref.lb_lookup_ref(codes, luts))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_in,n_out", [(1, 1, 1), (64, 40, 16),
                                          (100, 100, 3), (17, 64, 33)])
def test_cuda_bnn_popcount_matmul_equals_plain(cuda_device, B, n_in, n_out):
    *_, xp, wp = _bnn_case(B + n_out, B, n_in, n_out)
    xp[0, 0] |= np.uint32(1 << 31)  # a word with bit 31 set
    x, w = _t(xp).to(cuda_device), _t(wp).to(cuda_device)
    assert torch.equal(ops.bnn_popcount_matmul(x, w),
                       ref.bnn_popcount_matmul_ref(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("model,strategy,kernel,per_predict", [
    ("kmeans", "lb", "lb_lookup", 1), ("svm", "lb", "lb_lookup", 1),
    ("pca", "lb", "lb_lookup", 1), ("bnn", "dm", "bnn_popcount_matmul", 2)])
def test_cuda_lb_dm_predict_launches_its_kernel(cuda_device, model, strategy,
                                                kernel, per_predict):
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset

    ds = load_dataset("unsw", n=1500)
    y = None if model in ("kmeans", "pca") else ds.y_train
    cfg = PlanterConfig(model=model, strategy=strategy, size="S",
                        train_params={"epochs": 3} if model == "bnn" else {})
    res = plant(cfg, ds.X_train, y)
    assert res.mapped.select_backend(cuda_device) == "cuda"
    fn = res.mapped.torch_predict("auto", device=cuda_device)
    ops.reset_launch_counts()
    got = fn(ds.X_test).cpu().numpy()
    assert ops.launch_counts()[kernel] == per_predict
    want = res.mapped.predict(ds.X_test)
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def _pa_case(dev, seed, B, C, H, KV, hd, page, n_ps, quantized):
    """bf16 q, bf16 or int8 (+ scales) pools, a shuffled block table with
    an entry past the pool, positions; on ``dev``."""
    rng = np.random.default_rng(seed)
    N = B * n_ps
    tbl = rng.permutation(N).reshape(B, n_ps).astype(np.int32)
    tbl[0, -1] = N + 1
    pos0 = rng.integers(0, n_ps * page - C + 1, B)
    pos = (pos0[:, None] + np.arange(C)[None]).astype(np.int32)
    shape = (N, page, KV, hd)

    def t(a, dt):
        return torch.as_tensor(a, device=dev).to(dt)

    q = t(rng.normal(0, 1, (B, C, H, hd)), torch.bfloat16)
    if quantized:
        k, v = (t(rng.integers(-127, 128, shape), torch.int8) for _ in "kv")
        ks, vs = (t(rng.uniform(0.005, 0.02, shape[:-1] + (1,)),
                    torch.float32) for _ in "kv")
    else:
        k, v = (t(rng.normal(0, 1, shape), torch.bfloat16) for _ in "kv")
        ks = vs = None
    return q, k, v, t(tbl, torch.int32), t(pos, torch.int32), ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("H,KV,page", [(12, 2, 16), (4, 4, 8)])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [0, 13])
def test_cuda_paged_attention_equals_plain(cuda_device, C, H, KV, page,
                                           quantized, window):
    """Within one bf16 ulp of the output's largest magnitude (the kernel
    sums in float32 in another order than the plain version)."""
    q, k, v, tbl, pos, ks, vs = _pa_case(cuda_device, C + H, 3, C, H, KV,
                                         128, page, 96 // page, quantized)
    got = ops.paged_attention(q, k, v, tbl, pos, window, ks, vs)
    want = ref.paged_attention_ref(q, k, v, tbl, pos, window, ks, vs)
    ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
    assert (got.float() - want.float()).abs().max().item() <= ulp


@pytest.mark.cuda
def test_cuda_paged_attention_rows_are_invariant(cuda_device):
    """Bitwise: a slot alone vs in a batch, chunk rows vs C = 1 calls, and
    permuted physical pages."""
    dev = cuda_device
    q, k, v, tbl, pos, _, _ = _pa_case(dev, 1, 16, 8, 12, 2, 128, 16, 8,
                                       False)
    full = ops.paged_attention(q, k, v, tbl, pos, 0)
    for b in (0, 9):
        alone = ops.paged_attention(q[b:b + 1].contiguous(), k, v,
                                    tbl[b:b + 1].contiguous(),
                                    pos[b:b + 1].contiguous(), 0)
        assert torch.equal(alone[0], full[b])
    for c in range(8):
        one = ops.paged_attention(q[:, c:c + 1].contiguous(), k, v, tbl,
                                  pos[:, c:c + 1].contiguous(), 0)
        assert torch.equal(one[:, 0], full[:, c])
    perm = torch.randperm(k.shape[0], device=dev)
    k2, v2 = torch.empty_like(k), torch.empty_like(v)
    k2[perm], v2[perm] = k, v
    tbl2 = perm[tbl.clamp(0, k.shape[0] - 1).long()].to(torch.int32)
    assert torch.equal(ops.paged_attention(q, k2, v2, tbl2, pos, 0), full)


@pytest.mark.cuda
def test_cuda_paged_attention_refuses_scores_past_shared_memory(cuda_device):
    """A group's [G, S] scores past the card's opt-in shared memory (6 heads
    x 16,384 positions x 4 bytes) raise and count no launch; the refusal
    leaves no error behind for the next launch."""
    big = _pa_case(cuda_device, 2, 1, 1, 12, 2, 128, 16, 1024, False)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="S = 16384"):
        ops.paged_attention(*big[:5], 0)
    assert ops.launch_counts()["paged_attention"] == 0
    q, k, v, tbl, pos, _, _ = _pa_case(cuda_device, 3, 2, 1, 12, 2, 128, 16,
                                       4, False)
    got = ops.paged_attention(q, k, v, tbl, pos, 0)
    want = ref.paged_attention_ref(q, k, v, tbl, pos, 0)
    ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
    assert (got.float() - want.float()).abs().max().item() <= ulp


@pytest.mark.cuda
def test_cuda_serve_launches_paged_attention_per_layer(cuda_device):
    """The host batcher over the paged cache on the card: one
    paged_attention launch per layer per step, fused_eb at admission."""
    from repro_torch.arch import model as M
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.serve.engine import (ContinuousBatcher, ServeConfig,
                                          ServeEngine)

    cfg = get_smoke_config("qwen2-1.5b")
    ds = load_dataset("unsw", n=1500)
    gate = plant(PlanterConfig(model="rf", size="S"), ds.X_train,
                 ds.y_train).mapped
    engine = ServeEngine(cfg, M.init_params(cfg, 0, cuda_device),
                         ServeConfig(max_batch=4, cache_len=32, page_size=8),
                         gate=gate, device=cuda_device)
    cb = ContinuousBatcher(engine, eos_token=-1, max_tokens=4)
    ops.reset_launch_counts()
    for rid in range(6):
        cb.submit(rid, [rid + 1] * (rid + 2), features=ds.X_test[rid])
    done = cb.run(max_steps=200)
    counts = ops.launch_counts()
    assert counts["paged_attention"] == cb.steps * cfg.n_layers > 0
    assert counts["fused_eb"] > 0
    assert len(done) + len(cb.dropped) == 6
