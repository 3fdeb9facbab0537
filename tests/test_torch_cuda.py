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
