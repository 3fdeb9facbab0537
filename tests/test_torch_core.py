"""The port's plant -> predict path against the JAX package's, bitwise.

For dt, rf, xgb, iforest, knn-EB and kmeans-EB at size S on unsw
(``n=1500``): the fitted trainers are equal, ``resources()`` is equal, the
port's labels equal ``jax_predict("jnp")`` and ``jax_predict("pallas_fused")``
bit for bit, and ``eb_ensemble_from_arrays`` fed the JAX package's tables
predicts the same labels.

The same for the lookup-based (svm, nb, kmeans, pca, ae) and direct-map
(dt, rf, bnn) keys, with ``raw`` outputs (pca, ae) within
``rtol=atol=1e-5`` and the ``*_from_arrays`` builders.  The BNN trains in
float on either side, so its trainer is held to accuracy, and its mapping
is checked bitwise by feeding the JAX package's ``binary_weights()`` to the
port's ``map_bnn_dm``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import PlanterConfig as JaxConfig  # noqa: E402
from repro.core import plant as jax_plant  # noqa: E402
from repro.core.direct_map import DMBnn as JaxDMBnn  # noqa: E402
from repro.core.encode_based import \
    _thresholds_matrix as jax_thresholds_matrix  # noqa: E402
from repro.core.lookup_based import LBModel as JaxLBModel  # noqa: E402
from repro.core.tables import PackedBnn as JaxPackedBnn  # noqa: E402
from repro.data import load_dataset  # noqa: E402
from repro_torch.core import (  # noqa: E402
    PlanterConfig,
    direct_map,
    dm_bnn_from_arrays,
    dm_forest_from_arrays,
    eb_ensemble_from_arrays,
    lb_model_from_arrays,
    lookup_based,
    plant,
)
from repro_torch.core.encode_based import (  # noqa: E402
    _mapped,
    _thresholds_matrix,
)
from repro_torch.core.tables import FeatureTable, pack_bits_uint32  # noqa: E402

MODELS = ["dt", "rf", "xgb", "iforest", "knn", "kmeans"]
LB_DM = ["svm-lb", "nb-lb", "kmeans-lb", "pca-lb", "ae-lb", "dt-dm", "rf-dm",
         "bnn-dm"]
NOT_BNN = [k for k in LB_DM if k != "bnn-dm"]
UNSUPERVISED = {"kmeans", "pca", "ae"}
N_TEST = 300
_CACHE = {}


def _planted(model, strategy="eb"):
    """(jax PlanterResult, port PlanterResult, test flows), built once."""
    if (model, strategy) not in _CACHE:
        ds = load_dataset("unsw", n=1500)
        y = None if model in UNSUPERVISED else ds.y_train
        params = {"epochs": 3} if model == "bnn" else {}
        ref = jax_plant(JaxConfig(model=model, strategy=strategy, size="S",
                                  train_params=dict(params)),
                        ds.X_train, y, ds.X_test)
        port = plant(PlanterConfig(model=model, strategy=strategy, size="S",
                                   device="cpu", train_params=dict(params)),
                     ds.X_train, y, ds.X_test)
        _CACHE[(model, strategy)] = (ref, port, ds.X_test[:N_TEST])
    return _CACHE[(model, strategy)]


def _key(case):
    model, strategy = case.split("-")
    return _planted(model, strategy)


def _assert_outputs(got, want, err_msg=""):
    """Labels bitwise; LB ``raw`` float outputs within 1e-5."""
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind == "f":
        assert got.shape == want.shape, err_msg
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=err_msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=err_msg)


def _assert_same(a, b, path="model"):
    """Structural equality of two fitted trainers across the packages."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif dataclasses.is_dataclass(a) or hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, path
        fields = (dataclasses.asdict(a) if dataclasses.is_dataclass(a)
                  and not hasattr(a, "__dict__") else vars(a))
        other = vars(b)
        assert fields.keys() == other.keys(), path
        for k in fields:
            _assert_same(fields[k], other[k], f"{path}.{k}")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("model", MODELS)
def test_trainers_equal_reference(model):
    ref, port, _ = _planted(model)
    _assert_same(ref.trained, port.trained)
    assert ref.parity == port.parity


@pytest.mark.parametrize("model", MODELS)
def test_resources_equal_reference(model):
    ref, port, _ = _planted(model)
    assert dataclasses.astuple(ref.mapped.resources()) == \
        dataclasses.astuple(port.mapped.resources())
    assert ref.mapped.pipeline.summary() == port.mapped.pipeline.summary()
    assert ref.mapped.gate_sized() == port.mapped.gate_sized()


@pytest.mark.parametrize("model", MODELS)
def test_labels_equal_jax(model):
    ref, port, X = _planted(model)
    want = np.asarray(ref.mapped.jax_predict("jnp")(X))
    np.testing.assert_array_equal(
        want, np.asarray(ref.mapped.jax_predict("pallas_fused")(X)))
    np.testing.assert_array_equal(want, port.mapped.predict(X))
    for backend in ("ref", "cuda", "cuda_fused", "auto"):
        got = port.mapped.torch_predict(backend, device="cpu")(X)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)


@pytest.mark.parametrize("model", MODELS)
def test_tables_from_reference_arrays(model):
    ref, _, X = _planted(model)
    ens = ref.mapped.predict_np.__self__  # the JAX package's EBTreeEnsemble
    d = {
        "thresholds": [ft.thresholds for ft in ens.ftables],
        "in_bits": ens.in_bits,
        "tables": [{"values": t.values, "masks": t.masks,
                    "priorities": t.priorities, "actions": t.actions,
                    "default_action": t.default_action} for t in ens.tables],
        "combine": ens.combine, "n_classes": ens.n_classes,
        "tree_class": ens.tree_class, "sum_threshold": ens.sum_threshold,
        "dequant": ens.dequant,
    }
    mapped = _mapped(model, eb_ensemble_from_arrays(d))
    assert dataclasses.astuple(mapped.resources()) == \
        dataclasses.astuple(ref.mapped.resources())
    want = np.asarray(ref.mapped.jax_predict("jnp")(X))
    for backend in ("ref", "cuda_fused"):
        got = mapped.torch_predict(backend, device="cpu")(X).numpy()
        np.testing.assert_array_equal(got, want, err_msg=backend)


def test_select_backend_and_gate_size():
    _, port, _ = _planted("rf")
    mapped = port.mapped
    assert mapped.gate_sized()
    assert mapped.select_backend("cuda") == "cuda_fused"
    assert mapped.select_backend("cpu") == "ref"
    mapped.GATE_MAX_ENTRIES = 0  # instance override: not gate-sized
    assert mapped.select_backend("cuda") == "cuda"


# --------------------------------------------- lookup-based and direct-map
@pytest.mark.parametrize("case", NOT_BNN)
def test_lb_dm_trainers_equal_reference(case):
    ref, port, _ = _key(case)
    _assert_same(ref.trained, port.trained)
    assert ref.parity == port.parity


@pytest.mark.parametrize("case", LB_DM)
def test_lb_dm_resources_equal_reference(case):
    ref, port, _ = _key(case)
    assert dataclasses.astuple(ref.mapped.resources()) == \
        dataclasses.astuple(port.mapped.resources())
    assert ref.mapped.pipeline.summary() == port.mapped.pipeline.summary()
    assert port.mapped.strategy == case.split("-")[1]
    if case.endswith("-lb"):  # the same quantized tables, bit for bit
        want, got = ref.mapped.predict_np.__self__, port.mapped.predict_np.__self__
        np.testing.assert_array_equal(got.luts, want.luts)
        np.testing.assert_array_equal(got.bias_q, want.bias_q)
        assert (got.scale, got.mode, got.action_bits) == \
            (want.scale, want.mode, want.action_bits)


@pytest.mark.parametrize("case", NOT_BNN)
def test_lb_dm_labels_equal_jax(case):
    ref, port, X = _key(case)
    want = np.asarray(ref.mapped.jax_predict("jnp")(X))
    np.testing.assert_array_equal(port.mapped.predict(X), ref.mapped.predict(X))
    for backend in ("ref", "cuda", "auto"):
        got = port.mapped.torch_predict(backend, device="cpu")(X)
        assert got.dtype == (torch.float32 if want.dtype.kind == "f"
                             else torch.int32)
        _assert_outputs(got.numpy(), want, err_msg=backend)
    with pytest.raises(ValueError, match="cuda_fused"):
        port.mapped.torch_predict("cuda_fused", device="cpu")


@pytest.mark.parametrize("case", LB_DM)
def test_lb_dm_tables_from_reference_arrays(case):
    ref, _, X = _key(case)
    model = ref.mapped.predict_np.__self__  # the JAX package's runtime
    if case.endswith("-lb"):
        mapped = lookup_based._mapped(case, lb_model_from_arrays(
            model.luts, model.bias_q, model.mode, model.action_bits,
            model.in_bits, model.scale, model.pairs, model.n_classes))
    elif case == "bnn-dm":
        mapped = direct_map._mapped("bnn", dm_bnn_from_arrays(
            model.packed.layers, model.in_bits, model.n_features))
    else:
        mapped = direct_map._mapped(case, dm_forest_from_arrays(
            [dataclasses.asdict(nt) for nt in model.node_tables],
            model.n_classes, model.combine))
    assert dataclasses.astuple(mapped.resources()) == \
        dataclasses.astuple(ref.mapped.resources())
    want = np.asarray(ref.mapped.jax_predict("jnp")(X))
    _assert_outputs(mapped.predict(X), want, "numpy")
    for backend in ("ref", "cuda"):
        got = mapped.torch_predict(backend, device="cpu")(X).numpy()
        _assert_outputs(got, want, err_msg=backend)


def test_bnn_reference_weights_map_to_jax_labels():
    """The JAX package's trained ±1 weights through the port's mapper."""
    ref, _, X = _planted("bnn", "dm")
    mapped = direct_map.map_bnn_dm(ref.trained, X.shape[1], 8)
    want = np.asarray(ref.mapped.jax_predict("jnp")(X))
    np.testing.assert_array_equal(mapped.predict(X), want)
    np.testing.assert_array_equal(mapped.predict(X), ref.trained.predict(X))
    for backend in ("ref", "cuda", "auto"):
        got = mapped.torch_predict(backend, device="cpu")(X).numpy()
        np.testing.assert_array_equal(got, want, err_msg=backend)


def test_bnn_trainer_accuracy_tracks_jax():
    ref, port, _ = _planted("bnn", "dm")
    ds = load_dataset("unsw", n=1500)
    acc_ref = float((ref.trained.predict(ds.X_test) == ds.y_test).mean())
    acc = float((port.trained.predict(ds.X_test) == ds.y_test).mean())
    assert acc >= 0.60, acc
    assert abs(acc - acc_ref) <= 0.05, (acc, acc_ref)
    assert port.parity == 1.0  # DM-BNN is exact (paper Table 4)
    native = port.trained.predict(ds.X_test)
    got = port.mapped.torch_predict("cuda", device="cpu")(ds.X_test).numpy()
    np.testing.assert_array_equal(got, native)


# sums per flow (feature value v -> LUT row v) built to tie
_TIES = {
    "argmax": [[5, 5, 1], [2, 7, 7], [3, 3, 3], [0, 9, 1]],
    "argmin": [[5, 5, 1], [2, 7, 2], [3, 3, 3], [9, 4, 4]],
    "ovo_vote": [[1, -1, 1], [-1, 1, -1], [-1, -1, 1], [1, 1, 1]],
}


@pytest.mark.parametrize("mode", sorted(_TIES))
def test_lb_combine_ties_take_the_first_index(mode):
    luts = np.asarray(_TIES[mode], np.int32)[None]  # [F=1, V=4, K=3]
    kw = dict(luts=luts, bias_q=np.zeros(3, np.int32), mode=mode,
              action_bits=16, in_bits=2, scale=1.0,
              pairs=[(0, 1), (0, 2), (1, 2)], n_classes=3)
    X = np.arange(4)[:, None]
    want = np.asarray(JaxLBModel(**kw).make_jax_fn("jnp")(X))
    port = lb_model_from_arrays(**kw)
    np.testing.assert_array_equal(port.predict_np(X), want)
    got = port.make_torch_fn("cuda", torch.device("cpu"))(X).numpy()
    np.testing.assert_array_equal(got, want)
    first = {"argmax": [0, 1, 0, 1], "argmin": [2, 0, 0, 1],
             "ovo_vote": [0, 0, 1, 0]}[mode]
    assert want.tolist() == first


def _with_out_of_range(X, V):
    """``X`` and a copy of it with features past both ends of [0, V)."""
    bad = np.array(X, np.int64)
    bad[::3, 0] = -5
    bad[1::4, -1] = V + 40
    bad[2::5, 1] = np.iinfo(np.int32).min
    return np.concatenate([X, bad])


@pytest.mark.parametrize("case", ["svm-iris", "nb-unsw", "kmeans-unsw",
                                  "pca-unsw", "ae-unsw"])
def test_lb_predict_equals_jax_with_features_out_of_range(case):
    """The LB predict as one call (the kernel's plain version on the CPU)
    against ``make_jax_fn`` through the jnp oracle and the Pallas kernel
    (interpret mode): svm on iris (3 classes, 3 pairs, real votes) and nb,
    kmeans, pca, ae on unsw at size L (action_bits 16), with features
    below 0 and past V - 1, which clamp."""
    model, dataset = case.split("-")
    ds = load_dataset(dataset, n=600 if dataset == "iris" else 1500)
    y = None if model in UNSUPERVISED else ds.y_train
    ref = jax_plant(JaxConfig(model=model, strategy="lb", size="L"),
                    ds.X_train, y, ds.X_test)
    port = plant(PlanterConfig(model=model, strategy="lb", size="L",
                               device="cpu"), ds.X_train, y, ds.X_test)
    lb = port.mapped.predict_np.__self__
    if model == "svm":
        assert (lb.n_classes, len(lb.pairs)) == (3, 3)
    X = _with_out_of_range(ds.X_test[:200], lb.luts.shape[1])
    for backend in ("jnp", "pallas"):
        want = np.asarray(ref.mapped.jax_predict(backend)(X))
        for port_backend in ("ref", "cuda", "auto"):
            got = port.mapped.torch_predict(port_backend, device="cpu")(X)
            _assert_outputs(got.numpy(), want,
                            err_msg=f"{backend} vs {port_backend}")
    _assert_outputs(port.mapped.predict(X), ref.mapped.predict(X))


@pytest.mark.parametrize("size", ["S", "M", "L"])
def test_thresholds_matrix_equals_jax_and_is_sorted(size):
    """The bucketize kernel's binary search needs non-decreasing rows: the
    matrices of the rf-EB plants are the JAX package's, sorted, padded at
    the end with INT32_MAX."""
    ds = load_dataset("unsw", n=1500)
    ref = jax_plant(JaxConfig(model="rf", strategy="eb", size=size),
                    ds.X_train, ds.y_train, ds.X_test)
    port = plant(PlanterConfig(model="rf", strategy="eb", size=size,
                               device="cpu"), ds.X_train, ds.y_train,
                 ds.X_test)
    want = jax_thresholds_matrix(ref.mapped.predict_np.__self__.ftables)
    got = _thresholds_matrix(port.mapped.predict_np.__self__.ftables)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (np.diff(got.astype(np.int64)) >= 0).all()
    assert (got[:, -1] == np.iinfo(np.int32).max).any()


@pytest.mark.parametrize("maker", ["eb_ensemble_from_arrays",
                                   "_thresholds_matrix"])
def test_unsorted_threshold_rows_raise(maker):
    rows = [np.array([3, 9, 20]), np.array([7, 5])]  # feature 1 unsorted
    with pytest.raises(ValueError, match=r"\[1\]"):
        if maker == "_thresholds_matrix":
            _thresholds_matrix([FeatureTable(r, 8) for r in rows])
        else:
            eb_ensemble_from_arrays({
                "thresholds": rows, "in_bits": 8, "combine": "single",
                "n_classes": 2,
                "tables": [{"values": np.zeros((1, 1), np.uint32),
                            "masks": np.zeros((1, 1), np.uint32),
                            "priorities": np.zeros(1, np.int32),
                            "actions": np.zeros(1, np.int32),
                            "default_action": 0}]})


@pytest.mark.parametrize("hidden", [(16,), (32,), (48,), (33, 16)])
def test_bnn_dm_cpu_labels_equal_jax(hidden):
    """Random ±1 layers of the S/M/L widths (and two hidden layers): the
    port's predict on the CPU (fused-mode plain versions) equals the JAX
    package's, on flows with values past in_bits and negative ones."""
    rng = np.random.default_rng(sum(hidden))
    ds = load_dataset("unsw", n=1500)
    X = ds.X_test[:N_TEST].astype(np.int64)
    X[:20] = rng.integers(-300, 600, (20, X.shape[1]))
    dims = [X.shape[1] * ds.in_bits, *hidden, 2]
    layers = [(pack_bits_uint32(rng.integers(0, 2, (n_out, n_in)) * 2 - 1),
               n_in) for n_in, n_out in zip(dims[:-1], dims[1:])]
    want = np.asarray(JaxDMBnn(JaxPackedBnn(layers), ds.in_bits,
                               X.shape[1]).make_jax_fn("jnp")(X))
    mapped = direct_map._mapped("bnn", dm_bnn_from_arrays(
        layers, ds.in_bits, X.shape[1]))
    np.testing.assert_array_equal(mapped.predict(X), want)
    for backend in ("ref", "cuda", "auto"):
        got = mapped.torch_predict(backend, device="cpu")(X)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)
