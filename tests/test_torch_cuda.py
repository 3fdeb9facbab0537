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


def _unsorted_bucketize_case(seed, B, T):
    """Values against threshold rows in any order: ``[5, 3, INT32_MAX]``
    (T = 3), a reversed sorted row, a sorted row and a row with ties
    (the rows a binary search alone would get wrong, beside one it gets
    right); values on and between the thresholds, INT32_MAX and below
    zero."""
    rng = np.random.default_rng(seed)
    sorted_row = np.sort(rng.integers(0, 50, T))
    rows = [sorted_row[::-1], sorted_row, rng.integers(0, 4, T)]
    if T == 3:
        rows.insert(0, np.array([5, 3, INT32_MAX]))
    thr = np.stack(rows).astype(np.int32)
    vals = rng.integers(-2, 55, (B, len(rows))).astype(np.int32)
    vals[::5] = thr[:, rng.integers(0, T)]  # on a threshold
    vals[1::7] = INT32_MAX
    return vals, thr


def _lb_out_of_range_case(seed, B, F, V, K):
    """Codes outside ``[0, V)`` (-V-1, -1, V, INT32_MAX, INT32_MIN) mixed
    with valid ones; LUT values small enough for the Pallas kernel's
    float32 product to be exact."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, V, (B, F)).astype(np.int64)
    bad = np.array([-V - 1, -1, V, INT32_MAX, np.iinfo(np.int32).min])
    hit = rng.random((B, F)) < 0.4
    codes[hit] = bad[rng.integers(0, len(bad), int(hit.sum()))]
    codes[0] = bad[np.arange(F) % len(bad)]  # a row of bad codes only
    luts = rng.integers(-2**15, 2**15, (F, V, K)).astype(np.int32)
    return codes.astype(np.int32), luts


def _lb_predict_case(seed, B, F, V, K, n_classes, lim=2**12):
    """Raw features for the LB predict modes, in ``[0, V)`` and outside it
    (-1, -V-1, V, V+7, INT32_MIN, INT32_MAX); coarse LUT entries, with one
    column equal to another on every other code, so that sums tie; a bias
    whose add wraps int32 for some rows (``s[0]`` past INT32_MAX, ``s[-1]``
    below INT32_MIN); the one-vs-one pairs of ``n_classes`` classes in the
    SVM's order.  LUT sums stay under 2^24, where the Pallas kernel's
    float32 product is exact."""
    from itertools import combinations

    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (B, F)).astype(np.int64)
    bad = np.array([-1, -V - 1, V, V + 7, np.iinfo(np.int32).min, INT32_MAX])
    hit = rng.random((B, F)) < 0.25
    x[hit] = bad[rng.integers(0, len(bad), int(hit.sum()))]
    luts = rng.integers(-lim, lim, (F, V, K)) // 8 * 8
    if K > 1:
        luts[:, ::2, 1] = luts[:, ::2, 0]
    bias = rng.integers(-2**8, 2**8, K)
    bias[0] = INT32_MAX - lim
    if K > 1:
        bias[-1] = np.iinfo(np.int32).min + lim
    pairs = np.array(list(combinations(range(n_classes), 2))[:K],
                     np.int32).reshape(-1, 2)
    return (x.astype(np.int32), luts.astype(np.int32), bias.astype(np.int32),
            pairs)


# (F, V, K, n_classes) of the predict-mode grids: K = 1, 3 (register
# chunk of 4), 6 (of 8) and 15 (past the register cap: chunks of 8, and
# ovo_vote counting class by class)
LB_PREDICT_SHAPES = [(5, 256, 1, 2), (5, 256, 3, 3), (4, 16, 6, 4),
                     (3, 64, 15, 6)]


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


# (K, N, out float32) of the serve step's products: qwen2-1.5b's wq / wo,
# wk / wv, w_gate / w_up, w_down and the head (float32 logits), the smoke
# config's, a K past no 64-row tile with N under one 128-column tile, and
# the products qwen2-moe-a2.7b's step adds: the router, the experts' gate /
# up ([D, E_p x F]), the shared experts' gate / up and their down
LINEAR_SHAPES = [(1536, 1536, False), (1536, 256, False),
                 (1536, 8960, False), (8960, 1536, False),
                 (1536, 152064, True), (48, 48, False), (48, 16, False),
                 (96, 48, False), (48, 256, True), (40, 24, False),
                 (2048, 64, False), (2048, 90112, False),
                 (2048, 5632, False), (5632, 2048, False)]
LINEAR_ROWS = (1, 3, 16, 48, 64, 128, 256)


def _linear_case(seed, M, K, N):
    """bf16 activations ~ N(0, 1) [M, K] and weights ~ N(0, 1/K) [K, N],
    as numpy float32 arrays holding bf16 values."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((M, K), np.float32))
    w = torch.as_tensor(rng.standard_normal((K, N), np.float32) / np.sqrt(K))
    return (x.to(torch.bfloat16).float().numpy(),
            w.to(torch.bfloat16).float().numpy())


def linear_limit(x: torch.Tensor, w: torch.Tensor, want: torch.Tensor,
                 f32: bool) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for x [M, K] @ w [K, N]: the
    bf16 products are exact in float32, and any two float32 summation
    orders of K terms differ by at most 2 K 2^-24 sum|x||w|; a bf16 output
    adds one bf16 ulp (2^-7 of the magnitude) of the larger result."""
    gap = 2 * w.shape[0] * 2.0 ** -24 * (x.float().abs() @ w.float().abs())
    if f32:
        return gap
    return gap + 2.0 ** -7 * (want.float().abs() + gap)


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


# W -> (in_bits, F) of a feature input that packs into W words
_BNN_FEATURES = {1: (8, 3), 2: (8, 5), 3: (7, 13), 4: (5, 25), 10: (9, 35)}


@pytest.mark.cuda
@pytest.mark.parametrize("W", sorted(_BNN_FEATURES))
@pytest.mark.parametrize("N", [48, 33])
def test_cuda_bnn_modes_equal_plain(cuda_device, W, N):
    """Packed or feature input (prologue) x counts, sign words or scores,
    bitwise, over 300,001 rows (many persistent strides); W 1-4 take one
    vector load, W = 10 the run-time chunks; features past in_bits and
    negative."""
    dev, B = cuda_device, 300001
    rng = np.random.default_rng(W * 100 + N)
    in_bits, F = _BNN_FEATURES[W]
    w = _t(rng.integers(0, 2**32, (N, W), dtype=np.uint32)).to(dev)
    feats = _t(rng.integers(-2**31, 2**31, (B, F))).to(dev)
    packed = _t(rng.integers(0, 2**32, (B, W), dtype=np.uint32)).to(dev)
    for x, bits, n_in in ((packed, 0, 32 * W - 5),
                          (feats, in_bits, F * in_bits)):
        for ep in ("counts", "sign", "score"):
            got = ops.bnn_popcount_matmul(x, w, bits, ep, n_in)
            want = torch.cat([
                ref.bnn_popcount_matmul_ref(x[i:i + 65536], w, bits, ep, n_in)
                for i in range(0, B, 65536)])
            assert torch.equal(got, want), (bits, ep)


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,T", [(5000, 5, 1), (5000, 5, 37),
                                   (3000, 8, 2000), (2001, 8, 8000),
                                   (300001, 5, 28)])
def test_cuda_bucketize_binary_search_equals_plain(cuda_device, B, F, T):
    """T = 1, T not a power of two, rows past 48 KB (opt-in) and past the
    shared-memory budget (through L1), many persistent strides; INT32_MAX
    values against the padding; aligned and at an offset."""
    vals, thr = _bucketize_case(B + T, B + 1, F, T, int32_max=True)
    v, t = _t(vals).to(cuda_device), _t(thr).to(cuda_device)
    for x in (v[:B], v[1:]):
        assert torch.equal(ops.bucketize(x, t), ref.bucketize_ref(x, t))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1000, 3), (300001, 28), (5000, 8000)])
def test_cuda_bucketize_any_row_order_equals_plain(cuda_device, B, T):
    """Rows that are not non-decreasing are compare-counted, bitwise with
    the plain version, with the rows in shared memory and (T = 8000: four
    rows of 32 KB, past its budget) read through L1."""
    vals, thr = _unsorted_bucketize_case(T, B, T)
    v, t = _t(vals).to(cuda_device), _t(thr).to(cuda_device)
    assert torch.equal(ops.bucketize(v, t), ref.bucketize_ref(v, t))


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,V,K", [(100, 5, 64, 6), (3000, 8, 256, 16),
                                     (2049, 5, 256, 3)])
def test_cuda_lb_lookup_out_of_range_codes_equal_plain(cuda_device, B, F, V,
                                                       K):
    """A code outside [0, V) adds 0, bitwise with the plain version, with
    the LUT in shared memory and (the last two) read through the cache."""
    codes, luts = (_t(a).to(cuda_device)
                   for a in _lb_out_of_range_case(B, B, F, V, K))
    assert torch.equal(ops.lb_lookup(codes, luts), ref.lb_lookup_ref(codes, luts))


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,V,K,n_classes", [
    (300001, *shape) for shape in LB_PREDICT_SHAPES] + [
    (3000, 8, 256, 16, 7),   # LUT of 128 KB: opted-in shared memory
    (2049, 8, 1024, 8, 5),   # LUT of 256 KB: read through the cache
    (1, 1, 2, 1, 2)])
@pytest.mark.parametrize("mode", ["argmax", "argmin", "ovo_vote", "raw"])
def test_cuda_lb_predict_modes_equal_plain(cuda_device, mode, B, F, V, K,
                                           n_classes):
    """Every predict mode of the one launch against its plain version on
    the same inputs: labels bitwise, raw within 1e-5; features outside
    [0, V) clamp, the bias wraps, sums tie."""
    x, luts, bias, pairs = (_t(a).to(cuda_device) for a in _lb_predict_case(
        B + K, B, F, V, K, n_classes))
    kw = dict(bias=bias, scale=0.37)
    if mode == "ovo_vote":
        kw.update(pairs=pairs, n_classes=n_classes)
    got = ops.lb_lookup(x, luts, mode, **kw)
    want = torch.cat([ref.lb_lookup_ref(x[i:i + 65536], luts, mode, **kw)
                      for i in range(0, B, 65536)])
    if mode == "raw":
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want)


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


def _overwrite_past(seed, tbl, pos, *pools):
    """Copies of ``pools`` ([N, page, ...] each; float, int8 or scale
    planes) whose rows at logical positions past each slot's largest
    position hold other finite values.  A physical row that some slot
    reaches at or before its largest position (a table entry clipped onto
    another slot's page) is kept."""
    N, page = pools[0].shape[:2]
    S = tbl.shape[1] * page
    s = torch.arange(S)
    rows = tbl.cpu().long().clamp(0, N - 1)[:, s // page] * page + s % page
    last = pos.cpu().long().amax(dim=1, keepdim=True)
    keep = set(rows[s[None] <= last].tolist())
    past = sorted(set(rows[s[None] > last].tolist()) - keep)
    assert past, "no row lies past every position"
    idx = torch.as_tensor(past)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for pool in pools:
        new = pool.clone().reshape(N * page, *pool.shape[2:])
        shape = (len(past), *pool.shape[2:])
        if pool.dtype == torch.int8:
            fresh = torch.randint(-127, 128, shape, generator=gen)
        else:  # K/V rows and positive scales: other finite values
            fresh = torch.rand(shape, generator=gen) * 40 - 20
            if pool.shape[-1] == 1:
                fresh = fresh.abs() + 1e-3
        new[idx.to(pool.device)] = fresh.to(pool.dtype).to(pool.device)
        out.append(new.reshape(pool.shape))
    return out


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
@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("window", [0, 13])
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_paged_attention_ignores_rows_past_each_position(
        cuda_device, C, window, quantized):
    """Bitwise: the kernel never reads a row past every position of its
    slot, so other values there change nothing; a row at position -1 (it
    sees nothing) takes the full axis, within one bf16 ulp of the plain
    version."""
    q, k, v, tbl, pos, ks, vs = _pa_case(cuda_device, C + window, 4, C, 12,
                                         2, 128, 16, 16, quantized)
    base = torch.tensor([[0], [3], [40], [200]], dtype=torch.int32,
                        device=cuda_device)
    pos = (pos - pos[:, :1] + base).contiguous()
    got = ops.paged_attention(q, k, v, tbl, pos, window, ks, vs)
    pools = _overwrite_past(C, tbl, pos, k, v, *([ks, vs] if quantized
                                                 else []))
    k2, v2, ks2, vs2 = (pools + [None, None])[:4]
    assert torch.equal(ops.paged_attention(q, k2, v2, tbl, pos, window, ks2,
                                           vs2), got)
    pos[0, 0] = -1
    got = ops.paged_attention(q, k, v, tbl, pos, window, ks, vs)
    want = ref.paged_attention_ref(q, k, v, tbl, pos, window, ks, vs)
    ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
    assert (got.float() - want.float()).abs().max().item() <= ulp


@pytest.mark.cuda
def test_cuda_paged_attention_refuses_scores_past_shared_memory(cuda_device):
    """A rank's [C*G, S/8] scores past the card's opt-in shared memory (a
    chunk of 16 rows x 6 heads x 2,048 positions x 4 bytes) raise and
    count no launch; the refusal leaves no error behind for the next
    launch."""
    big = _pa_case(cuda_device, 2, 1, 16, 12, 2, 128, 16, 1024, False)
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


def _device_serve(cuda_device, graph, n=6, max_steps=200, prefill_chunk=4,
                  arch="qwen2-1.5b", **scfg):
    """The device batcher on ``arch``'s smoke config (rf-S gate), ``n``
    requests of 2-7 tokens, chunk 4, three steps a round."""
    from repro_torch.arch import model as M
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.serve.engine import (DeviceContinuousBatcher,
                                          ServeConfig, ServeEngine)

    cfg = get_smoke_config(arch)
    ds = load_dataset("unsw", n=1500)
    gate = plant(PlanterConfig(model="rf", size="S"), ds.X_train,
                 ds.y_train).mapped
    engine = ServeEngine(cfg, M.init_params(cfg, 0, cuda_device),
                         ServeConfig(max_batch=4, cache_len=32, page_size=8,
                                     **scfg),
                         gate=gate, device=cuda_device)
    cb = DeviceContinuousBatcher(engine, eos_token=-1, max_tokens=4,
                                 sync_every=3, prefill_chunk=prefill_chunk,
                                 graph=graph)
    for rid in range(n):
        cb.submit(rid, [rid + 1] * (rid + 2), features=ds.X_test[rid])
    cb.run(max_steps=max_steps)
    return cb


@pytest.mark.cuda
@pytest.mark.parametrize("share", [False, True])
def test_cuda_device_batcher_graph_equals_eager(cuda_device, share):
    """The replayed CUDA graph gives the eager step's streams, drops and
    refcounts bitwise, and steps with work as many."""
    graph = _device_serve(cuda_device, True, share_prefix=share)
    eager = _device_serve(cuda_device, False, share_prefix=share)
    assert graph.graph and not eager.graph
    assert graph.done == eager.done and len(graph.done) > 0
    assert graph.dropped == eager.dropped and graph.steps == eager.steps
    np.testing.assert_array_equal(graph.pool.ref, eager.pool.ref)


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [False, True])
def test_cuda_device_batcher_round_never_syncs(cuda_device, graph):
    """A round of the fused step, from a mid-flight state, makes no
    synchronising call (``set_sync_debug_mode("error")`` would raise)."""
    cb = _device_serve(cuda_device, graph, max_steps=2)
    (fs,) = cb._steps.values()
    assert not fs.st["free"].all()
    torch.cuda.synchronize(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fs.run(3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("none_kept", [False, True])
def test_cuda_sync_free_pool_write_equals_the_filtered_write(cuda_device,
                                                            none_kept):
    """On the card the pool write without ``nonzero`` leaves the pool as
    the filtered write does, and makes no synchronising call."""
    from repro_torch.nn import attention as A
    from repro_torch.nn.attn_backend import PagedKV

    rng = np.random.default_rng(3)
    N, page, KV, hd, B, C = 6, 4, 2, 16, 4, 3
    cells = rng.permutation(N * page)[: B * C]
    ids, off = cells // page, cells % page
    ids[[0, 4, 7]] = [N, N + 2, -1]
    if none_kept:
        ids[:] = N
    dev = cuda_device
    ids = torch.as_tensor(ids.reshape(B, C), dtype=torch.int32, device=dev)
    off = torch.as_tensor(off.reshape(B, C), dtype=torch.int32, device=dev)
    k = torch.randn((B, C, KV, hd), device=dev).to(torch.bfloat16)
    v = torch.randn((B, C, KV, hd), device=dev).to(torch.bfloat16)
    pool = [torch.randn((N, page, KV, hd), device=dev).to(torch.bfloat16)
            for _ in range(2)]
    kv = PagedKV(*[p.clone() for p in pool])
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        A._paged_write(kv.with_view(None, None, ids, off,
                                    A.write_rows(ids, off, N, page)), k, v)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    keep = torch.nonzero(((ids >= 0) & (ids < N)).reshape(-1)).squeeze(1)
    for p, rows in zip(pool, (k, v)):
        p.index_put_((ids.reshape(-1)[keep].long(),
                      off.reshape(-1)[keep].long()),
                     rows.reshape(-1, KV, hd)[keep])
    assert torch.equal(kv.k, pool[0]) and torch.equal(kv.v, pool[1])


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,f32", LINEAR_SHAPES)
def test_cuda_linear_within_limits_of_plain(cuda_device, K, N, f32):
    """The kernel against ``ref.linear_ref`` on the card (float32
    accumulation on both: reduced-precision reductions off), elementwise
    within ``linear_limit``."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = torch.float32 if f32 else None
    for M in (1, 16, 128):
        x, w = (torch.as_tensor(a).to(cuda_device).to(torch.bfloat16)
                for a in _linear_case(M + K, M, K, N))
        got = ops.linear(x, w, out)
        want = ref.linear_ref(x, w, out)
        assert got.dtype == want.dtype and got.shape == (M, N)
        bad = (got.float() - want.float()).abs() > linear_limit(x, w, want,
                                                                f32)
        assert not bad.any(), (M, int(bad.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,f32", LINEAR_SHAPES)
def test_cuda_linear_rows_are_invariant(cuda_device, K, N, f32):
    """Bitwise: a row's result is the same whatever M and wherever the
    row sits (alone, at the start, at an offset, at the end)."""
    out = torch.float32 if f32 else None
    x, w = (torch.as_tensor(a).to(cuda_device).to(torch.bfloat16)
            for a in _linear_case(K + N, 300, K, N))
    full = ops.linear(x, w, out)
    for M in LINEAR_ROWS:
        for o in (0, 7, 300 - M):
            part = ops.linear(x[o:o + M].contiguous(), w, out)
            assert torch.equal(part, full[o:o + M]), (M, o)


# groups of weights sharing K: qwen2-1.5b's q/k/v and gate/up, one whose
# members have S = 8, 2 and 8 (a cluster of 8 holding four tiles of the
# middle member, two of them padding), qwen2-moe-a2.7b's experts' and
# shared experts' gate/up, xlstm-125m's mLSTM q/k and gates (w_if: the
# 2 x 4 gate columns) and recurrentgemma-9b's RG-LRU lin/gate and q/k/v
LINEAR_GROUPS = [((1536, 1536), (1536, 256), (1536, 256)),
                 ((1536, 8960), (1536, 8960)),
                 ((2048, 136), (2048, 8960), (2048, 24)),
                 ((2048, 90112), (2048, 90112)), ((2048, 5632), (2048, 5632)),
                 ((768, 768), (768, 768), (768, 8)),
                 ((4096, 4096), (4096, 4096)),
                 ((4096, 4096), (4096, 256), (4096, 256))]


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", LINEAR_GROUPS)
def test_cuda_linear_group_equals_lone_launches(cuda_device, shapes):
    """Bitwise: each member of a grouped launch is its own launch alone,
    at every M (bf16 and float32 out); a group is one launch."""
    K = shapes[0][0]
    x = torch.as_tensor(_linear_case(K, 300, K, 8)[0]).to(
        cuda_device).to(torch.bfloat16)
    ws = [torch.as_tensor(_linear_case(K + i, 1, K, N)[1]).to(
        cuda_device).to(torch.bfloat16) for i, (_, N) in enumerate(shapes)]
    for out in (None, torch.float32):
        for M in (1, 16, 100, 128, 256):
            xm = x[:M].contiguous()
            ops.reset_launch_counts()
            got = ops.linear_group(xm, ws, out)
            assert ops.launch_counts()["linear"] == 1
            for g, w in zip(got, ws):
                assert torch.equal(g, ops.linear(xm, w, out)), (M, w.shape)


@pytest.mark.cuda
def test_cuda_linear_refuses_what_it_does_not_take(cuda_device):
    x = torch.ones((4, 12), dtype=torch.bfloat16, device=cuda_device)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.linear(x, torch.ones((12, 16), dtype=torch.bfloat16,
                                 device=cuda_device))
    with pytest.raises(TypeError, match="bf16"):
        ops.linear(x.float()[:, :8], torch.ones((8, 16), device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        ops.linear(x[:, :8], torch.ones((16, 8), dtype=torch.bfloat16,
                                        device=cuda_device).T)
    assert ops.launch_counts()["linear"] == 0


@pytest.mark.cuda
def test_cuda_mlstm_gate_products(cuda_device):
    """xlstm-125m's ``w_i`` and ``w_f`` ([768, 4], N = 4): the kernel
    refuses N = 4; as ``w_if`` (``mlstm_gate_weights``, [768, 8]) they are
    one member of the q/k launch, each gate column within ``linear_limit``
    of its own plain product, in a decode step's and a training
    microbatch's row counts."""
    from repro_torch.nn.recurrent import mlstm_gate_weights

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    K = 768
    x = torch.as_tensor(_linear_case(5, 300, K, 8)[0]).to(
        cuda_device).to(torch.bfloat16)
    w_i, w_f = (torch.as_tensor(_linear_case(6 + i, 1, K, 4)[1]).to(
        cuda_device).to(torch.bfloat16) for i in range(2))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.linear(x[:16].contiguous(), w_i.contiguous())
    assert ops.launch_counts()["linear"] == 0
    w_if = mlstm_gate_weights(w_i, w_f)
    assert w_if.shape == (K, 8) and torch.equal(w_if, torch.cat([w_i, w_f],
                                                                1))
    wq = torch.as_tensor(_linear_case(9, 1, K, K)[1]).to(cuda_device).to(
        torch.bfloat16)
    for M in (1, 16, 256):  # a decode step's slots, a training microbatch
        xm = x[:M].contiguous()
        _, _, g = ops.linear_group(xm, [wq, wq, w_if])
        for cols, w in ((slice(0, 4), w_i), (slice(4, 8), w_f)):
            want = ref.linear_ref(xm, w)
            err = (g[:, cols].float() - want.float()).abs()
            assert (err <= linear_limit(xm, w, want, False)).all(), M
        assert torch.equal(g, ops.linear(xm, w_if))


def _recurrent_serve(cuda_device, arch, cls, graph=True, n=10,
                     max_tokens=6, cache_len=8):
    """``arch``'s smoke config (rf-S gate) through a dense batcher on the
    card: ``n`` single-token requests through 4 slots."""
    from repro_torch.arch import model as M
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.serve import engine as E

    cfg = get_smoke_config(arch)
    ds = load_dataset("unsw", n=1500)
    gate = plant(PlanterConfig(model="rf", size="S"), ds.X_train,
                 ds.y_train).mapped
    engine = E.ServeEngine(cfg, M.init_params(cfg, 0, cuda_device),
                           E.ServeConfig(max_batch=4, cache_len=cache_len),
                           gate=gate, device=cuda_device)
    kw = dict(eos_token=-1, max_tokens=max_tokens)
    cb = (E.ContinuousBatcher(engine, **kw) if cls == "host" else
          E.DeviceContinuousBatcher(engine, sync_every=3, graph=graph, **kw))
    for rid in range(n):
        cb.submit(rid, rid + 7, features=ds.X_test[rid])
    cb.run(max_steps=200)
    return cb


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-9b"])
def test_cuda_recurrent_dense_step_captured(cuda_device, arch):
    """The recurrent families' dense step as a CUDA graph: the captured
    device batcher == the eager one == the host batcher, bitwise (cache 8:
    recurrentgemma's rings wrap); the step launches ``linear`` (and
    ``paged_attention`` for the hybrid); a round makes no synchronising
    call, and a round past the work leaves every recurrent state and ring
    bitwise as it was."""
    host = _recurrent_serve(cuda_device, arch, "host")
    ops.reset_launch_counts()
    graph = _recurrent_serve(cuda_device, arch, "device")
    counts = ops.launch_counts()
    eager = _recurrent_serve(cuda_device, arch, "device", graph=False)
    assert graph.done == eager.done == host.done and len(host.done) > 0
    assert graph.dropped == eager.dropped == host.dropped
    assert graph.steps == eager.steps == host.steps > 8
    assert counts["linear"] > 0
    assert (counts["paged_attention"] > 0) == (arch == "recurrentgemma-9b")
    cb = _recurrent_serve(cuda_device, arch, "device", n=4, max_tokens=40)
    assert all(cb.submit(10 + i, i + 3) for i in range(4))
    cb.run(max_steps=3)
    fs = list(cb._steps.values())[-1]
    assert not fs.st["free"].all()
    torch.cuda.synchronize(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fs.run(3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cb.run(max_steps=400)
    assert fs.st["free"].all()
    state = [t.clone() for v in cb._decode.values()
             for t in (v.values() if isinstance(v, dict) else
                       v if isinstance(v, tuple) else [v])]
    fs.run(4)  # every slot free, the queue empty: identity steps
    after = [t for v in cb._decode.values()
             for t in (v.values() if isinstance(v, dict) else
                       v if isinstance(v, tuple) else [v])]
    assert all(torch.equal(a, b) for a, b in zip(state, after))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-large-v2"])
def test_cuda_frontend_dense_step_captured(cuda_device, arch):
    """The VLM and enc-dec families' dense step as a CUDA graph: the
    captured device batcher == the eager one == the host batcher, bitwise
    (cache 8: the rings wrap); the step launches ``paged_attention`` and
    ``linear``; the enc-dec ``cross`` planes stay zero, as the JAX
    package's serve path leaves them."""
    host = _recurrent_serve(cuda_device, arch, "host")
    ops.reset_launch_counts()
    graph = _recurrent_serve(cuda_device, arch, "device")
    counts = ops.launch_counts()
    eager = _recurrent_serve(cuda_device, arch, "device", graph=False)
    assert graph.done == eager.done == host.done and len(host.done) > 0
    assert graph.dropped == eager.dropped == host.dropped
    assert graph.steps == eager.steps == host.steps > 8
    assert counts["linear"] > 0 and counts["paged_attention"] > 0
    if arch == "seamless-m4t-large-v2":
        for st in (graph._decode, eager._decode, host.engine.state):
            assert all(not t.any() for t in st["cross"])


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16, 256, 4096])
def test_cuda_cross_query_projection_is_the_group_bits(cuda_device, M):
    """seamless-m4t-large-v2's cross-attention projects its query alone:
    at its width (K = N = 1,024) ``ops.linear`` of ``wq`` gives the bits of
    the q/k/v group launch's first output, at M from one decode slot to
    one utterance's 4,096 frames."""
    rng = np.random.default_rng(M)
    x = torch.as_tensor(rng.normal(0, 1, (M, 1024)), dtype=torch.bfloat16,
                        device=cuda_device)
    ws = [torch.as_tensor(rng.normal(0, 0.03, (1024, 1024)),
                          dtype=torch.bfloat16, device=cuda_device)
          for _ in range(3)]
    assert torch.equal(ops.linear(x, ws[0]), ops.linear_group(x, ws)[0])


@pytest.mark.cuda
def test_cuda_encdec_cross_decode_equals_forward(cuda_device):
    """The enc-dec smoke config on the card: teacher-forced decode with its
    ``cross`` planes filled by ``encode_cross`` within the JAX package's
    0.15 of the forward over the same frames (every product the ``linear``
    kernel, the self-attention ``paged_attention``)."""
    from repro_torch.arch import model as M
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("seamless-m4t-large-v2")
    params = M.init_params(cfg, 0, cuda_device)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 12)),
                           dtype=torch.int32, device=cuda_device)
    frames = torch.as_tensor(
        rng.normal(0, 1, (2, cfg.frontend_seq, cfg.frontend_dim)),
        dtype=torch.float32, device=cuda_device)
    ops.reset_launch_counts()
    with torch.no_grad():
        fwd, _ = M.forward(params, {"tokens": toks, "frames": frames}, cfg,
                           q_block=12)
        st = M.init_decode_state(cfg, 2, 12, device=cuda_device)
        st["cross"] = M.encode_cross(params, frames, cfg)
        errs = []
        for t in range(12):
            lg, st = M.decode_step(params, st, toks[:, t:t + 1], cfg)
            errs.append((lg - fwd[:, t]).abs().max().item())
    assert max(errs) < 0.15, errs
    counts = ops.launch_counts()
    assert counts["linear"] > 0 and counts["paged_attention"] == 12 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 13, 2048])
def test_cuda_paged_attention_ring_at_recurrentgemma_shape(cuda_device,
                                                           window):
    """recurrentgemma-9b's attention: hd 256 (the kernel's limit), 16 query
    heads on 1 KV head (its limit too), 1,024 ring cells, positions past
    the wrap (its window of 2,048 longer than the ring): within one bf16
    ulp of the plain version; below the wrap bitwise the launch without
    the ring."""
    S = 1024
    q, k, v, tbl, _, _ = _ring_case(cuda_device, window + 3, 4, S, False,
                                    H=16, KV=1, hd=256)
    for p0 in (S, S + 5, 2 * S + 50, 3 * S + 5):
        pos = torch.tensor([[p0], [p0 + 1], [p0 + 12], [p0 + 700]],
                           dtype=torch.int32, device=cuda_device)
        got = ops.paged_attention(q, k, v, tbl, pos, window, ring=True)
        want = ref.paged_attention_ref(q, k, v, tbl, pos, window, ring=True)
        ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
        assert (got.float() - want.float()).abs().max().item() <= ulp, p0
    pos = torch.tensor([[0], [7], [500], [S - 1]], dtype=torch.int32,
                       device=cuda_device)
    assert torch.equal(ops.paged_attention(q, k, v, tbl, pos, window,
                                           ring=True),
                       ops.paged_attention(q, k, v, tbl, pos, window))


@pytest.mark.cuda
def test_cuda_chunked_prefill_equals_token_by_token(cuda_device):
    """Through the device batcher on the card: chunk 4 and chunk 1 give
    every stream bitwise (the products no longer depend on M)."""
    a = _device_serve(cuda_device, True, n=8)
    b = _device_serve(cuda_device, True, n=8, prefill_chunk=1)
    assert a.done == b.done and len(a.done) > 0
    assert a.dropped == b.dropped


# ------------------------------------------------------ the dense ring
def _ring_case(dev, seed, B, S, quantized, H=12, KV=2, hd=128):
    """bf16 q and one layer of a dense cache [B, S, KV, hd] (bf16, or int8
    with scales) read as B pages of S positions: the identity table."""
    rng = np.random.default_rng(seed)
    shape = (B, S, KV, hd)

    def t(a, dt):
        return torch.as_tensor(a, device=dev).to(dt)

    q = t(rng.normal(0, 1, (B, 1, H, hd)), torch.bfloat16)
    if quantized:
        k, v = (t(rng.integers(-127, 128, shape), torch.int8) for _ in "kv")
        ks, vs = (t(rng.uniform(0.005, 0.02, shape[:-1] + (1,)),
                    torch.float32) for _ in "kv")
    else:
        k, v = (t(rng.normal(0, 1, shape), torch.bfloat16) for _ in "kv")
        ks = vs = None
    tbl = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    return q, k, v, tbl, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 13])
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_paged_attention_ring_equals_plain(cuda_device, window,
                                                quantized):
    """The ring past the wrap (positions S to 3S + 5, the window inside
    one lap or wrapping round cell 0) within one bf16 ulp of the plain
    version; below the wrap bitwise the launch without the ring."""
    S = 96
    q, k, v, tbl, ks, vs = _ring_case(cuda_device, window, 4, S, quantized)
    for p0 in (S, S + 5, 2 * S + 50, 3 * S + 5):
        pos = torch.tensor([[p0], [p0 + 1], [p0 + 12], [p0 + 40]],
                           dtype=torch.int32, device=cuda_device)
        got = ops.paged_attention(q, k, v, tbl, pos, window, ks, vs,
                                  ring=True)
        want = ref.paged_attention_ref(q, k, v, tbl, pos, window, ks, vs,
                                       ring=True)
        ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
        assert (got.float() - want.float()).abs().max().item() <= ulp
    pos = torch.tensor([[0], [7], [50], [S - 1]], dtype=torch.int32,
                       device=cuda_device)
    assert torch.equal(
        ops.paged_attention(q, k, v, tbl, pos, window, ks, vs, ring=True),
        ops.paged_attention(q, k, v, tbl, pos, window, ks, vs))


def _dense_serve(cuda_device, cls, graph=True, page_size=0, n=4,
                 max_tokens=5, cache_len=32, max_steps=200):
    """The smoke config (rf-S gate) through a dense or paged batcher on
    the card: ``n`` single-token requests."""
    from repro_torch.arch import model as M
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.serve import engine as E

    cfg = get_smoke_config("qwen2-1.5b")
    ds = load_dataset("unsw", n=1500)
    gate = plant(PlanterConfig(model="rf", size="S"), ds.X_train,
                 ds.y_train).mapped
    engine = E.ServeEngine(cfg, M.init_params(cfg, 0, cuda_device),
                           E.ServeConfig(max_batch=4, cache_len=cache_len,
                                         page_size=page_size),
                           gate=gate, device=cuda_device)
    kw = dict(eos_token=-1, max_tokens=max_tokens)
    cb = (E.ContinuousBatcher(engine, **kw) if cls == "host" else
          E.DeviceContinuousBatcher(engine, sync_every=3, graph=graph, **kw))
    for rid in range(n):
        cb.submit(rid, rid + 7, features=ds.X_test[rid])
    cb.run(max_steps=max_steps)
    return cb


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["device", "host"])
def test_cuda_paged_decode_bit_identical_to_dense(cuda_device, cls):
    """On the card, where attention is the kernel: one wave of single-token
    requests, every slot admitted at step 0, paged == dense bitwise."""
    dense = _dense_serve(cuda_device, cls)
    paged = _dense_serve(cuda_device, cls, page_size=8)
    assert dense.done == paged.done and len(dense.done) > 0


@pytest.mark.cuda
def test_cuda_dense_device_equals_host_across_the_wrap(cuda_device):
    """Ten requests through four slots, cache 8 (the global position
    wraps): the dense device batcher (graph and eager) == the dense host
    batcher, bitwise; a step launches paged_attention once a layer."""
    host = _dense_serve(cuda_device, "host", n=10, cache_len=8)
    ops.reset_launch_counts()
    graph = _dense_serve(cuda_device, "device", n=10, cache_len=8)
    eager = _dense_serve(cuda_device, "device", graph=False, n=10,
                         cache_len=8)
    assert graph.done == eager.done == host.done and host.steps > 8
    assert graph.dropped == eager.dropped == host.dropped
    assert graph.steps == eager.steps == host.steps
    assert ops.launch_counts()["paged_attention"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [False, True])
def test_cuda_dense_round_never_syncs(cuda_device, graph):
    """A round of the dense fused step, from a mid-flight state, makes no
    synchronising call; a round past the work leaves ``pos`` and the cache
    bitwise as they were."""
    cb = _dense_serve(cuda_device, "device", graph=graph, max_steps=2)
    (fs,) = cb._steps.values()
    assert not fs.st["free"].all()
    torch.cuda.synchronize(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fs.run(3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(cuda_device)
    cb.run(max_steps=200)
    assert fs.st["free"].all()
    pos = int(cb._decode["pos"])
    planes = [p.clone() for p in cb._decode["kv"]]
    fs.run(4)  # every slot free, the queue empty: identity steps
    assert int(cb._decode["pos"]) == pos
    assert all(torch.equal(a, b) for a, b in zip(planes, cb._decode["kv"]))


# ------------------------------------------------------------ the trainer
@pytest.mark.cuda
@pytest.mark.parametrize("K,N,f32", LINEAR_SHAPES[:5])
def test_cuda_linear_backward_equals_autograd_of_plain(cuda_device, K, N,
                                                       f32):
    """``ops.linear`` with a gradient at M = 256 and 512: the forward is
    one kernel launch within ``linear_limit`` of the plain version, and
    given the same ``dy``, ``dx`` and ``dw`` are bitwise autograd's through
    the plain product (``ref.linear_ref``; for the float32 head, the one
    float32 product ``x.float() @ w.float()`` whose value ``linear_ref``
    takes a row at a time): both are the same ``torch.matmul`` calls."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = torch.float32 if f32 else None
    for M in (256, 512):
        x, w = (torch.as_tensor(a).to(cuda_device).to(torch.bfloat16)
                for a in _linear_case(M + N, M, K, N))
        dy = torch.as_tensor(np.random.default_rng(M).standard_normal(
            (M, N), np.float32)).to(cuda_device)
        dy = dy if f32 else dy.to(torch.bfloat16)
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        ops.reset_launch_counts()
        y = ops.linear(xa, wa, out)
        assert ops.launch_counts()["linear"] == 1
        y.backward(dy)
        xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
        want = (xb.float() @ wb.float()) if f32 else ref.linear_ref(xb, wb)
        want.backward(dy)
        assert ops.launch_counts()["linear"] == 1  # the backward is matmuls
        bad = (y.detach().float() - want.detach().float()).abs() > \
            linear_limit(x, w, want.detach(), f32)
        assert not bad.any(), (M, int(bad.sum()))
        assert xa.grad.dtype == torch.bfloat16 == wa.grad.dtype
        assert torch.equal(xa.grad, xb.grad), (M, "dx")
        assert torch.equal(wa.grad, wb.grad), (M, "dw")


@pytest.mark.cuda
def test_cuda_train_step_launches_linear_and_tracks_plain(cuda_device):
    """One train step of the smoke config on the card: ``linear`` launches
    exactly microbatches x (2 x 4 x layers + 1) (each layer's four products
    in the forward and again in its recomputation under ``"full"`` remat,
    the head once), no other kernel; the loss within 5e-3 relative of the
    same step on the CPU (bf16 products summed in another order: about one
    bf16 ulp of an activation) and every updated master finite."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves, map_leaves

    cfg = get_smoke_config("qwen2-1.5b")
    tcfg = TrainConfig(microbatches=2, q_block=32)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0))
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    losses = {}
    for dev in ("cpu", cuda_device):
        params, state = init_train_state(cfg, tcfg, 0, "cpu")
        params = map_leaves(lambda l: [p.to(dev) for p in l.parts], params)
        state = map_leaves(lambda l: [p.to(dev) for p in l.parts], state)
        ops.reset_launch_counts()
        params, state, loss = make_train_step(cfg, tcfg)(
            params, state, {k: v.to(dev) for k, v in batch.items()})
        losses[str(dev)] = float(loss)
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        if dev != "cpu":
            assert counts == {"linear": 2 * (8 * cfg.n_layers + 1)}, counts
            assert all(torch.isfinite(p).all() for leaf in leaves(params)
                       for p in leaf.parts)
    cpu, card = losses["cpu"], losses[str(cuda_device)]
    assert abs(card - cpu) <= 5e-3 * abs(cpu), losses


# ------------------------------------------------------------- MoE
MOE_DIMS = dict(E=64, F=1408, D=2048, n_real=60, top_k=4)  # qwen2-moe
MOE_ROWS = (1, 7, 16, 128, 200, 256)
# skewed routings of combine_case, each at its M: every row's top expert the
# same one, every row on experts 0 .. top_k-1, each real expert picked by
# one row (60 / 4 rows), and every row on one expert alone
MOE_SKEWS = (("same_top", 128), ("first_k", 128), ("first_k", 200),
             ("one_each", 15), ("one_expert", 256))


def _bf16(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(
        torch.bfloat16)


def combine_case(seed, M, E, n_real, top_k, dev="cpu",
                 skew=None) -> torch.Tensor:
    """bf16 ``combine [M, E]``: each row's ``top_k`` of the ``n_real``
    experts with normalised weights, the rest 0; every third row's weights
    tied (1 / top_k each), every fifth row with one picked weight 0, and
    the last row all 0.  ``skew`` picks the experts otherwise:
    ``"same_top"`` gives every row expert ``n_real // 2`` as its first
    pick, ``"first_k"`` every row experts 0 .. top_k-1, ``"one_each"``
    row m experts m*top_k .. m*top_k + top_k-1 (each expert one row; rows
    past the experts pick none), and ``"one_expert"`` every row expert
    ``n_real // 3`` alone."""
    rng = np.random.default_rng(seed)
    c = np.zeros((M, E), np.float32)
    for m in range(M):
        pick = rng.choice(n_real, top_k, replace=False)
        if skew == "same_top":
            rest = [e for e in pick if e != n_real // 2]
            pick = np.array([n_real // 2, *rest[:top_k - 1]])
        elif skew == "first_k":
            pick = np.arange(top_k)
        elif skew == "one_each":
            pick = np.arange(m * top_k, (m + 1) * top_k)
            pick = pick[pick < n_real]
        elif skew == "one_expert":
            pick = np.array([n_real // 3])
        elif skew is not None:
            raise ValueError(f"unknown skew {skew!r}")
        vals = rng.uniform(0.05, 1.0, len(pick))
        if m % 3 == 0:
            vals[:] = 1.0
        vals = vals / max(vals.sum(), 1e-30)
        if m % 5 == 1 and len(pick) and skew != "one_expert":
            vals[0] = 0.0
        c[m, pick] = vals
    c[-1] = 0.0
    return _bf16(c, dev)


def moe_case(seed, M, E, F, D, n_real, top_k, dev="cpu", skew=None):
    """bf16 ``h [M, E, F]`` ~ N(0, 1), ``w_down [E, F, D]`` ~ N(0, 1/F) and
    ``combine_case``'s ``[M, E]`` weights (``skew`` as there)."""
    rng = np.random.default_rng(seed)
    h = _bf16(rng.standard_normal((M, E, F)), dev)
    w = _bf16(rng.standard_normal((E, F, D)) / np.sqrt(F), dev)
    return h, w, combine_case(seed + 1, M, E, n_real, top_k, dev, skew)


@pytest.mark.cuda
@pytest.mark.parametrize("M,skew", [(M, None) for M in MOE_ROWS]
                         + [(M, s) for s, M in MOE_SKEWS])
def test_cuda_moe_down_combine_equals_plain(cuda_device, M, skew):
    """The kernel bitwise equal to ``ref.moe_down_combine_ref`` on the
    card, at qwen2-moe's widths (64 experts, F 1408, D 2048), with tied
    and zero combine weights, on random and on skewed routing (one expert
    past the 128 rows a work item holds, experts with one row): every
    float32 sum runs in the plain version's order."""
    h, w, c = moe_case(M, M, **MOE_DIMS, dev=cuda_device, skew=skew)
    ops.reset_launch_counts()
    got = ops.moe_down_combine(h, w, c)
    assert ops.launch_counts()["moe_down_combine"] == 1
    want = ref.moe_down_combine_ref(h, w, c)
    assert got.dtype == torch.bfloat16 and got.shape == (M, MOE_DIMS["D"])
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [None, "same_top", "one_expert"])
def test_cuda_moe_down_combine_rows_are_invariant(cuda_device, skew):
    """Each row of a [16, ...] launch is bitwise the row launched alone,
    and the first 16 rows of a [144, ...] launch (past one work item's
    128 rows when every row is on one expert) the same rows again."""
    h, w, c = moe_case(3, 144, **MOE_DIMS, dev=cuda_device, skew=skew)
    big = ops.moe_down_combine(h, w, c)[:16]
    h, c = h[:16].contiguous(), c[:16].contiguous()
    full = ops.moe_down_combine(h, w, c)
    assert torch.equal(big, full)
    for m in range(16):
        alone = ops.moe_down_combine(h[m:m + 1].contiguous(), w,
                                     c[m:m + 1].contiguous())
        assert torch.equal(alone[0], full[m]), m


@pytest.mark.cuda
def test_cuda_moe_down_combine_replays_in_a_graph(cuda_device):
    """One call captured in a CUDA graph, then replayed on other inputs
    with other routing (random, then every row on experts 0-3, then every
    row on one expert): bitwise the plain version each time, and neither
    the capture nor a replay makes the host wait (the work list is built
    on the card, the launch depends on the shapes alone)."""
    M, E, F = 128, MOE_DIMS["E"], MOE_DIMS["F"]
    h, w, c = moe_case(5, M, **MOE_DIMS, dev=cuda_device)
    others = []
    for seed, skew in ((6, None), (7, "first_k"), (8, "one_expert")):
        rng = np.random.default_rng(seed)
        others.append((skew, _bf16(rng.standard_normal((M, E, F)),
                                   cuda_device),
                       combine_case(seed, M, E, MOE_DIMS["n_real"],
                                    MOE_DIMS["top_k"], cuda_device, skew)))
    ops.moe_down_combine(h, w, c)  # build and load outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            torch.cuda.set_sync_debug_mode("error")
            out = ops.moe_down_combine(h, w, c)
            torch.cuda.set_sync_debug_mode("default")
        for skew, h2, c2 in others:
            torch.cuda.set_sync_debug_mode("error")
            h.copy_(h2)
            c.copy_(c2)
            g.replay()
            torch.cuda.set_sync_debug_mode("default")
            assert torch.equal(out, ref.moe_down_combine_ref(h, w, c)), skew
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_cuda_moe_down_combine_refuses_what_it_does_not_take(cuda_device):
    h, w, c = moe_case(0, 4, 4, 48, 16, 4, 2, dev=cuda_device)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.moe_down_combine(h, w, c)
    h, w, c = moe_case(0, 4, 4, 32, 16, 4, 2, dev=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        ops.moe_down_combine(h.float(), w, c)
    with pytest.raises(TypeError, match="bf16"):  # with a gradient too
        ops.moe_down_combine(h.float(), w.requires_grad_(True), c)
    h, w, c = moe_case(0, 4, 12, 32, 16, 12, 2, dev=cuda_device)
    with pytest.raises(ValueError, match="E a multiple of 8"):
        ops.moe_down_combine(h, w, c)
    assert ops.launch_counts()["moe_down_combine"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("M", MOE_ROWS)
def test_cuda_moe_down_combine_gradient_equals_autograd_of_plain(cuda_device,
                                                                 M):
    """With a gradient, at qwen2-moe's widths: the forward one launch,
    bitwise the plain version; given the same cotangent, ``dh``,
    ``dW_down`` and the routed pairs' ``dcombine`` (the backward's
    ``torch.bmm`` products) within 0.03 of the largest magnitude of
    autograd's through ``ref.moe_down_combine_ref`` (bf16 products summed
    in other orders; phase 20 (b)'s bound), and ``dcombine`` 0 off the
    routed pairs."""
    h, w, c = moe_case(M + 40, M, **MOE_DIMS, dev=cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(M)
    dy = torch.randn((M, MOE_DIMS["D"]), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    a = [t.clone().requires_grad_(True) for t in (h, w, c)]
    ops.reset_launch_counts()
    out = ops.moe_down_combine(*a)
    assert ops.launch_counts()["moe_down_combine"] == 1
    out.backward(dy)
    assert ops.launch_counts()["moe_down_combine"] == 1
    b = [t.clone().requires_grad_(True) for t in (h, w, c)]
    want = ref.moe_down_combine_ref(*b)
    want.backward(dy)
    assert torch.equal(out, want)
    routed = c != 0
    for x, y, pick in ((a[0], b[0], None), (a[1], b[1], None),
                       (a[2], b[2], routed)):
        assert x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape
        gx, gy = x.grad.float(), y.grad.float()
        if pick is not None:
            assert (gx[~pick] == 0).all()
            gx, gy = gx[pick], gy[pick]
        if gy.numel():  # M = 1: combine_case's last row picks nothing
            assert (gx - gy).abs().max() <= 0.03 * gy.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
def test_cuda_moe_train_step_launches_its_kernels(cuda_device, arch):
    """One train step of the MoE smoke config on the card (the dense
    dispatch): ``linear`` launched exactly microbatches x (2 x products
    a layer x layers + 1) and ``moe_down_combine`` microbatches x 2 x
    layers (the forward and ``"full"`` remat's recomputation; its
    backward is ``torch.bmm``), no other kernel; every updated master
    finite; the loss within 5e-3 relative of the same step on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves, map_leaves

    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(microbatches=2, q_block=32)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0))
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    per_layer = 4 + 2 * bool(cfg.n_shared_experts)
    losses = {}
    for dev in ("cpu", cuda_device):
        params, state = init_train_state(cfg, tcfg, 0, "cpu")
        params = map_leaves(lambda l: [p.to(dev) for p in l.parts], params)
        state = map_leaves(lambda l: [p.to(dev) for p in l.parts], state)
        ops.reset_launch_counts()
        params, state, loss = make_train_step(cfg, tcfg)(
            params, state, {k: v.to(dev) for k, v in batch.items()})
        losses[str(dev)] = float(loss)
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        if dev != "cpu":
            assert counts == {
                "linear": 2 * (2 * per_layer * cfg.n_layers + 1),
                "moe_down_combine": 2 * 2 * cfg.n_layers}, counts
            assert all(torch.isfinite(p).all() for leaf in leaves(params)
                       for p in leaf.parts)
    cpu, card = losses["cpu"], losses[str(cuda_device)]
    assert abs(card - cpu) <= 5e-3 * abs(cpu), losses


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV", [(24, 8), (64, 8), (3, 1)])
@pytest.mark.parametrize("C", [1, 8])
def test_cuda_paged_attention_at_three_and_eight_heads_a_kv_head(
        cuda_device, H, KV, C):
    """minitron-4b's 3 query heads a KV head (24 on 8, and its smoke
    config's 3 on 1) and qwen3-32b's 8 (64 on 8), hd 128: within one bf16
    ulp of the plain version, with and without its window of 13."""
    q, k, v, tbl, pos, _, _ = _pa_case(cuda_device, H + C, 3, C, H, KV, 128,
                                       16, 8, False)
    for window in (0, 13):
        got = ops.paged_attention(q, k, v, tbl, pos, window)
        want = ref.paged_attention_ref(q, k, v, tbl, pos, window)
        ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
        assert (got.float() - want.float()).abs().max().item() <= ulp


@pytest.mark.cuda
def test_cuda_paged_attention_window_1024_over_a_ring_of_2048(cuda_device):
    """gemma3-27b's local layers: a window of 1,024 over a ring of 2,048
    cells (hd 128, 32 query heads on 16 KV heads), positions below and
    past the wrap: within one bf16 ulp of the plain version, and, where a
    row has passed 1,024 positions, other values than the same launch
    with no window (the window hides cells)."""
    S = 2048
    q, k, v, tbl, _, _ = _ring_case(cuda_device, 11, 4, S, False, H=32,
                                    KV=16, hd=128)
    for p0 in (1100, 1500, S + 5, 2 * S + 1000):
        pos = torch.tensor([[p0], [p0 + 1], [p0 + 300], [p0 + 900]],
                           dtype=torch.int32, device=cuda_device)
        got = ops.paged_attention(q, k, v, tbl, pos, 1024, ring=True)
        want = ref.paged_attention_ref(q, k, v, tbl, pos, 1024, ring=True)
        ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
        assert (got.float() - want.float()).abs().max().item() <= ulp, p0
        full = ops.paged_attention(q, k, v, tbl, pos, 0, ring=True)
        assert not torch.equal(got, full), p0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
def test_cuda_moe_chunked_prefill_equals_token_by_token(cuda_device, arch):
    """The MoE smoke configs through the device batcher on the card: chunk
    4 and chunk 1 give every stream bitwise; the step launches
    ``moe_down_combine``."""
    ops.reset_launch_counts()
    a = _device_serve(cuda_device, True, n=8, arch=arch)
    assert ops.launch_counts()["moe_down_combine"] > 0
    b = _device_serve(cuda_device, True, n=8, prefill_chunk=1, arch=arch)
    assert a.done == b.done and len(a.done) > 0
    assert a.dropped == b.dropped


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1536, 2048, 64])
def test_cuda_row_reductions_are_invariant(cuda_device, D):
    """``nn.common.row_sum`` (the float32 mean of ``rms_norm``, the MoE
    router's softmax sum) gives each row the same bits whatever the number
    of rows, where a plain ``sum(-1)`` on the card splits a row over more
    threads when there are few rows (ROADMAP C.11)."""
    from repro_torch.nn import moe
    from repro_torch.nn.common import rms_norm, row_sum

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(D)
    X = torch.randn((256, D), generator=gen, device=cuda_device)
    scale = torch.randn((D,), generator=gen, device=cuda_device) * 0.1
    router = (torch.randn((D, 64), generator=gen, device=cuda_device)
              / np.sqrt(D)).to(torch.bfloat16)
    full = (row_sum(X * X), rms_norm(X, scale),
            moe.route(X.to(torch.bfloat16), router, 60, 4))
    for M in (1, 2, 3, 4, 5, 8, 16, 32, 128):
        x = X[:M].contiguous()
        assert torch.equal(row_sum(x * x), full[0][:M]), M
        assert torch.equal(rms_norm(x, scale), full[1][:M]), M
        for got, want in zip(moe.route(x.to(torch.bfloat16), router, 60, 4),
                             full[2]):
            assert torch.equal(got, want[:M]), M


@pytest.mark.cuda
def test_cuda_capture_survives_a_dead_batcher(cuda_device):
    """A dead device batcher is a reference cycle with captured graphs; the
    collector running often (threshold 1) must not free it during another
    batcher's capture, which would invalidate it (ROADMAP C.12)."""
    import gc

    dead = _device_serve(cuda_device, True, n=2)
    assert all(fs.graph is not None for fs in dead._steps.values())
    del dead
    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        live = _device_serve(cuda_device, True, n=2)
    finally:
        gc.set_threshold(*old)
    assert live.graph and len(live.done) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b"])
def test_cuda_dots_equals_full(cuda_device, arch):
    """``remat_policy="dots"`` on the card: the loss and every gradient
    bitwise ``"full"``'s (both recompute row-invariant launches or none),
    and ``linear`` launched for the forward alone (``"full"`` launches each
    layer's products again in the backward)."""
    from repro_torch.arch import model as M
    from repro_torch.configs import get_smoke_config
    from repro_torch.tree import leaves

    cfg = get_smoke_config(arch)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)).to(cuda_device)
    out = {}
    for policy in ("full", "dots"):
        ps = M.init_params(cfg, 0, cuda_device, masters=True)
        parts = [p.requires_grad_(True) for leaf in leaves(ps)
                 for p in leaf.parts]
        ops.reset_launch_counts()
        loss = M.loss_fn(ps, {"tokens": tokens}, cfg, q_block=32,
                         remat_policy=policy)
        fwd = ops.launch_counts()["linear"]
        loss.backward()
        out[policy] = (loss.detach(), [p.grad for p in parts], fwd,
                       ops.launch_counts()["linear"] - fwd)
    assert torch.equal(out["dots"][0], out["full"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["dots"][1],
                                                 out["full"][1]))
    assert out["dots"][2:] == (out["full"][2], 0)
    assert out["full"][3] == out["full"][2] - 1  # all but the head again


@pytest.mark.cuda
def test_cuda_elastic_drill_replays_bitwise(cuda_device, tmp_path):
    """``tests/test_elastic.py``'s drill on the card (qwen2-1.5b smoke, 4
    workers of 2 logical chips, a straggler evicted, the latest manifest
    corrupted, a host lost): segments init / straggler / host-loss, 12
    steps, 2 workers left, and every recovered segment's losses its
    ``replay``'s bit for bit."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.dist.elastic import TrainFaultPlan
    from repro_torch.train import TrainConfig
    from repro_torch.train.elastic import ElasticTrainer
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_smoke_config("qwen2-1.5b")
    tcfg = TrainConfig(microbatches=2, q_block=32, adamw=AdamWConfig(
        lr=2e-3, warmup_steps=3, total_steps=12))
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0))
    trainer = ElasticTrainer(
        cfg, tcfg, pipe, CheckpointManager(str(tmp_path), keep=0), steps=12,
        n_workers=4, model_parallel=2, chips_per_host=2,
        plan=TrainFaultPlan.parse(
            "slow:1:9.0:5@1, corrupt:manifest@6, lost:2@7"),
        min_strikes=3, ckpt_every=3, log=None, device=cuda_device)
    res = trainer.run()
    assert res.completed and res.steps_completed == 12
    assert [s.cause for s in res.segments] == ["init", "straggler",
                                               "host-loss"]
    assert len(res.workers_final) == 2
    for seg in res.segments[1:]:
        assert trainer.replay(seg.ckpt_step, seg.device_ids, seg.mesh_shape,
                              seg.n_steps) == seg.losses, seg.cause
