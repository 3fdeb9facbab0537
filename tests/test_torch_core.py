"""The port's EB plant -> predict path against the JAX package's, bitwise.

For dt, rf, xgb, iforest, knn-EB and kmeans-EB at size S on unsw
(``n=1500``): the fitted trainers are equal, ``resources()`` is equal, the
port's labels equal ``jax_predict("jnp")`` and ``jax_predict("pallas_fused")``
bit for bit, and ``eb_ensemble_from_arrays`` fed the JAX package's tables
predicts the same labels.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import PlanterConfig as JaxConfig  # noqa: E402
from repro.core import plant as jax_plant  # noqa: E402
from repro.data import load_dataset  # noqa: E402
from repro_torch.core import PlanterConfig, eb_ensemble_from_arrays, plant  # noqa: E402
from repro_torch.core.encode_based import _mapped  # noqa: E402

MODELS = ["dt", "rf", "xgb", "iforest", "knn", "kmeans"]
N_TEST = 300
_CACHE = {}


def _planted(model):
    """(jax PlanterResult, port PlanterResult, test flows), built once."""
    if model not in _CACHE:
        ds = load_dataset("unsw", n=1500)
        y = None if model == "kmeans" else ds.y_train
        ref = jax_plant(JaxConfig(model=model, strategy="eb", size="S"),
                        ds.X_train, y, ds.X_test)
        port = plant(PlanterConfig(model=model, strategy="eb", size="S",
                                   device="cpu"), ds.X_train, y, ds.X_test)
        _CACHE[model] = (ref, port, ds.X_test[:N_TEST])
    return _CACHE[model]


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
