"""Planter's one-click workflow: config -> train -> map -> compile -> test.

Mirrors the paper's seven workflow steps (Fig. 2): ① load dataset ② train
③ map to tables ④ compile ⑤ load to target (tables onto the device)
⑥ table entries installed ⑦ auto-generated functionality test
(mapped-vs-native parity check).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from .. import ml
from ..device import resolve_device
from . import direct_map, encode_based, lookup_based
from .pipeline import MappedModel

# (model, strategy) -> mapper(trained_model, n_features, in_bits, **kw)
MAPPERS: Dict[Tuple[str, str], Callable] = {
    ("dt", "eb"): encode_based.map_dt_eb,
    ("rf", "eb"): encode_based.map_rf_eb,
    ("xgb", "eb"): encode_based.map_xgb_eb,
    ("iforest", "eb"): encode_based.map_iforest_eb,
    ("dt", "dm"): direct_map.map_dt_dm,
    ("rf", "dm"): direct_map.map_rf_dm,
    ("bnn", "dm"): direct_map.map_bnn_dm,
    ("svm", "lb"): lookup_based.map_svm_lb,
    ("nb", "lb"): lookup_based.map_nb_lb,
    ("kmeans", "lb"): lookup_based.map_kmeans_lb,
    ("pca", "lb"): lookup_based.map_pca_lb,
    ("ae", "lb"): lookup_based.map_ae_lb,
}

# default strategy per model (paper Table 2)
DEFAULT_STRATEGY = {
    "dt": "eb", "rf": "eb", "xgb": "eb", "iforest": "eb", "kmeans": "lb",
    "knn": "eb", "svm": "lb", "nb": "lb", "pca": "lb", "ae": "lb",
    "bnn": "dm",
}

# paper Table 6 model-size gradients (S/M/L); H = full precision on host
SIZE_PARAMS: Dict[str, Dict[str, Dict[str, Any]]] = {
    "S": {
        "dt": dict(max_depth=4), "rf": dict(max_depth=4, n_estimators=6),
        "xgb": dict(max_depth=4, n_estimators=2),
        "iforest": dict(n_estimators=3, max_samples=128),
        "svm": dict(), "nb": dict(), "kmeans": dict(),
        "knn": dict(n_neighbors=5), "pca": dict(), "ae": dict(),
        "bnn": dict(hidden=(16,)),
        "convert": dict(action_bits=8, km_depth=2),
    },
    "M": {
        "dt": dict(max_depth=5), "rf": dict(max_depth=5, n_estimators=9),
        "xgb": dict(max_depth=5, n_estimators=3),
        "iforest": dict(n_estimators=9, max_samples=128),
        "svm": dict(), "nb": dict(), "kmeans": dict(),
        "knn": dict(n_neighbors=5), "pca": dict(), "ae": dict(),
        "bnn": dict(hidden=(32,)),
        "convert": dict(action_bits=16, km_depth=3),
    },
    "L": {
        "dt": dict(max_depth=6), "rf": dict(max_depth=6, n_estimators=12),
        "xgb": dict(max_depth=6, n_estimators=4),
        "iforest": dict(n_estimators=12, max_samples=128),
        "svm": dict(), "nb": dict(), "kmeans": dict(),
        "knn": dict(n_neighbors=5), "pca": dict(), "ae": dict(),
        "bnn": dict(hidden=(48,)),
        "convert": dict(action_bits=16, km_depth=4),
    },
}


@dataclasses.dataclass
class PlanterConfig:
    """The paper's Input Configurations component."""

    model: str = "rf"
    strategy: Optional[str] = None  # None -> Table 2 default
    size: str = "M"  # S | M | L
    in_bits: int = 8
    action_bits: Optional[int] = None  # None -> size default
    device: str = "cuda"  # where the mapped model will predict
    train_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    convert_params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def resolved(self) -> "PlanterConfig":
        cfg = dataclasses.replace(self)
        if cfg.strategy is None:
            cfg.strategy = DEFAULT_STRATEGY[cfg.model]
        size = SIZE_PARAMS[cfg.size]
        if cfg.action_bits is None:
            cfg.action_bits = size["convert"]["action_bits"]
        merged = dict(size[cfg.model])
        merged.update(cfg.train_params)
        cfg.train_params = merged
        cfg.convert_params = dict(cfg.convert_params)  # plant adds defaults
        return cfg


@dataclasses.dataclass
class PlanterResult:
    config: PlanterConfig
    trained: Any
    mapped: MappedModel
    train_seconds: float
    convert_seconds: float
    parity: float  # mapped-vs-native agreement on the test split


def train_model(cfg: PlanterConfig, X: np.ndarray, y: Optional[np.ndarray]):
    model = ml.MODEL_REGISTRY[cfg.model](**cfg.train_params)
    if cfg.model in ("kmeans", "pca", "ae") or (cfg.model == "iforest"
                                                and y is None):
        return model.fit(X)  # unsupervised
    if cfg.model == "bnn":  # trains on the target device
        return model.fit(X, y, device=cfg.device)
    return model.fit(X, y)


def convert_model(cfg: PlanterConfig, trained, n_features: int) -> MappedModel:
    kw: Dict[str, Any] = dict(cfg.convert_params)
    if cfg.model in ("knn", "kmeans") and cfg.strategy == "eb":
        depth = kw.pop("km_depth", SIZE_PARAMS[cfg.size]["convert"]["km_depth"])
        mapper = (encode_based.map_knn_eb if cfg.model == "knn"
                  else encode_based.map_kmeans_eb)
        return mapper(trained, n_features, cfg.in_bits, max_depth=depth, **kw)
    if cfg.strategy == "lb":
        kw.setdefault("action_bits", cfg.action_bits)
    return MAPPERS[(cfg.model, cfg.strategy)](trained, n_features, cfg.in_bits,
                                             **kw)


def _parity(native: np.ndarray, dev: np.ndarray) -> float:
    """Classifiers: exact agreement.  Dimensional reduction: mean |Pearson
    r| per component (paper E.1), or 1 - relative error if they collapse."""
    if native.ndim == 1:
        return float((native == dev).mean())
    cors = []
    for j in range(native.shape[1]):
        if native[:, j].std() > 1e-9 and dev[:, j].std() > 1e-9:
            cors.append(abs(np.corrcoef(native[:, j], dev[:, j])[0, 1]))
    if cors:
        return float(np.mean(cors))
    err = np.abs(native - dev).max()
    scale = max(np.abs(native).max(), 1e-9)
    return float(max(0.0, 1.0 - err / scale))


def plant(
    cfg: PlanterConfig,
    X_train: np.ndarray,
    y_train: Optional[np.ndarray],
    X_test: Optional[np.ndarray] = None,
) -> PlanterResult:
    """One-click: train, map, and self-test (workflow steps ②③⑦).

    ``cfg.device`` is checked first (default ``cuda``), so a run that
    cannot deploy on its target fails before it trains.
    """
    cfg = cfg.resolved()
    resolve_device(cfg.device)
    if cfg.strategy == "lb":  # LB quantizer budgets the observed domain
        cfg.convert_params.setdefault(
            "feature_max", np.asarray(X_train).max(axis=0))
    t0 = time.perf_counter()
    trained = train_model(cfg, X_train, y_train)
    t1 = time.perf_counter()
    mapped = convert_model(cfg, trained, X_train.shape[1])
    t2 = time.perf_counter()
    parity = float("nan")
    if X_test is not None and hasattr(trained, "predict"):
        parity = _parity(np.asarray(trained.predict(X_test)),
                         np.asarray(mapped.predict(X_test)))
    return PlanterResult(
        config=cfg, trained=trained, mapped=mapped,
        train_seconds=t1 - t0, convert_seconds=t2 - t1, parity=parity,
    )
