"""Lookup-based (LB) mapping — paper §4.2.

Per-feature tables store quantized *intermediate results*; the final stage
is pure addition + argmax/argmin (Fig. 7).  Multiplication disappears by
precomputation (SVM/PCA/AE: ``w·x`` per feature value) or by log transform
(NB, Eq. 4).  ``map()`` is the paper's quantizer: a global scale chosen so
that the worst-case |sum over features| fits ``action_bits`` signed.

The predictor is one ``lb_lookup`` launch: it clamps the flows to the
table domain, gathers and accumulates over features (exact in int32 at
every ``action_bits``), adds the bias and makes the decision (argmax,
argmin, one-vs-one vote or dequantization) in the kernel's epilogue.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops, ref
from .pipeline import MappedModel, Pipeline, Stage
from .tables import LookupTable

MODES = ("argmax", "argmin", "raw", "ovo_vote")


def _quantize_tables(
    raw: np.ndarray, action_bits: int,
    feature_max: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, float]:
    """raw [F, V, K] float -> (int32 tables, scale).  q = round(scale*x).

    The scale is budgeted over the *observed* per-feature value domain
    (``feature_max``, from training data — the paper's "feature range")
    rather than the full 2^in_bits: otherwise features with narrow active
    ranges (flags, small enums) quantize to zero.  Entries beyond the
    observed domain saturate (standard quantizer behaviour).
    """
    F, V, K = raw.shape
    if feature_max is None:
        feature_max = np.full(F, V - 1, np.int64)
    worst = 0.0
    for f in range(F):
        hi = int(min(feature_max[f], V - 1))
        worst += np.abs(raw[f, : hi + 1]).max()
    qmax = 2 ** (action_bits - 1) - 1
    scale = qmax / max(worst, 1e-12)
    q = np.clip(np.round(raw * scale), -2**31 + 1, 2**31 - 1)
    return q.astype(np.int64).astype(np.int32), float(scale)


@dataclasses.dataclass
class LBModel:
    """Shared runtime for all LB mappings."""

    luts: np.ndarray  # [F, V, K] int32
    bias_q: np.ndarray  # [K] int32 added to sums
    mode: str  # 'argmax' | 'argmin' | 'raw' | 'ovo_vote'
    action_bits: int
    in_bits: int
    scale: float
    pairs: Optional[List[Tuple[int, int]]] = None  # for ovo_vote
    n_classes: int = 0

    def sums_np(self, X: np.ndarray) -> np.ndarray:
        X = np.clip(np.asarray(X, np.int64), 0, self.luts.shape[1] - 1)
        out = np.tile(self.bias_q.astype(np.int64), (len(X), 1))
        for f in range(self.luts.shape[0]):
            out += self.luts[f, X[:, f]]
        return out

    def predict_np(self, X: np.ndarray) -> np.ndarray:
        s = self.sums_np(X)
        if self.mode == "argmax":
            return s.argmax(axis=1)
        if self.mode == "argmin":
            return s.argmin(axis=1)
        if self.mode == "ovo_vote":
            votes = np.zeros((len(s), self.n_classes), np.int64)
            for m, (a, c) in enumerate(self.pairs):
                votes[np.arange(len(s)), np.where(s[:, m] > 0, a, c)] += 1
            return votes.argmax(axis=1)
        return s / self.scale  # raw (PCA/AE): dequantized outputs

    def make_torch_fn(self, backend: str, device: torch.device) -> Callable:
        """Predictor ``x [B, F]`` on ``device``: labels [B] int32, or float32
        outputs [B, K] in ``raw`` mode.

        ``"cuda"`` runs the whole predict (clamp, gather, bias, decision) as
        one ``lb_lookup`` launch (its plain version on a CPU device) and
        ``"ref"`` the plain version on any device.
        """
        if backend == "cuda":
            lookup = ops.lb_lookup
        elif backend == "ref":
            lookup = ref.lb_lookup_ref
        else:
            raise ValueError(f"backend {backend!r} is not an LB backend "
                             "('cuda' or 'ref')")
        args = self.kernel_args(device)

        def fn(x) -> torch.Tensor:
            x = torch.as_tensor(x).to(device=device, dtype=torch.int32)
            return lookup(x.contiguous(), *args)

        return fn

    def kernel_args(self, device: torch.device) -> tuple:
        """The arguments after ``x`` of the predict's ``lb_lookup`` call on
        ``device``: luts, epilogue (the mode), bias, pairs (ovo_vote, else
        None), n_classes and scale."""
        luts = torch.as_tensor(np.ascontiguousarray(self.luts, np.int32),
                               device=device)
        bias = torch.as_tensor(np.asarray(self.bias_q, np.int32), device=device)
        pairs = None
        if self.mode == "ovo_vote":
            pairs = torch.as_tensor(np.asarray(self.pairs, np.int32)
                                    .reshape(-1, 2), device=device)
        return luts, self.mode, bias, pairs, self.n_classes, self.scale

    def pipeline(self) -> Pipeline:
        F, V, K = self.luts.shape
        tabs = [
            LookupTable(self.luts[f], self.in_bits, self.action_bits)
            for f in range(F)
        ]
        return Pipeline(
            [Stage("feature_tables", "lut", tabs), Stage("decision", "logic", [])]
        )


def lb_model_from_arrays(
    luts: np.ndarray, bias_q: np.ndarray, mode: str, action_bits: int,
    in_bits: int, scale: float,
    pairs: Optional[Sequence[Tuple[int, int]]] = None, n_classes: int = 0,
) -> LBModel:
    """An ``LBModel`` from plain arrays, e.g. the JAX package's tables, so
    the port predicts with exactly what another builder mapped.
    ``_mapped(kind, model)`` wraps it as a ``MappedModel``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return LBModel(
        luts=np.asarray(luts, np.int32), bias_q=np.asarray(bias_q, np.int32),
        mode=mode, action_bits=int(action_bits), in_bits=int(in_bits),
        scale=float(scale),
        pairs=None if pairs is None else [(int(a), int(c)) for a, c in pairs],
        n_classes=int(n_classes),
    )


def _mapped(kind: str, lb: LBModel, meta=None) -> MappedModel:
    return MappedModel(
        model_kind=kind,
        strategy="lb",
        pipeline=lb.pipeline(),
        predict_np=lb.predict_np,
        make_torch_fn=lb.make_torch_fn,
        meta=meta or {},
    )


def map_svm_lb(model, n_features: int, in_bits: int,
               action_bits: int = 8,
               feature_max: Optional[np.ndarray] = None) -> MappedModel:
    """Feature table f stores w_m^f * v for every hyperplane m (IIsy v3)."""
    V = 2**in_bits
    vals = np.arange(V, dtype=np.float64)
    raw = np.einsum("mf,v->fvm", model.W_, vals)  # [F, V, M]
    luts, scale = _quantize_tables(raw, action_bits, feature_max)
    bias_q = np.round(model.b_ * scale).astype(np.int32)
    lb = LBModel(
        luts, bias_q, "ovo_vote", action_bits, in_bits, scale,
        pairs=list(model.pairs_), n_classes=model.n_classes_,
    )
    return _mapped("svm", lb)


def map_nb_lb(model, n_features: int, in_bits: int,
              action_bits: int = 8,
              feature_max: Optional[np.ndarray] = None) -> MappedModel:
    """Upgraded log-domain NB (paper Eq. 4): sums of log2 P replace products."""
    V = 2**in_bits
    K = model.n_classes_
    raw = np.zeros((n_features, V, K))
    for f in range(n_features):
        tab = model.feature_log_prob_[f]  # [V_f, K]
        idx = np.clip(np.arange(V), 0, tab.shape[0] - 1)
        raw[f] = tab[idx]
    luts, scale = _quantize_tables(raw, action_bits, feature_max)
    bias_q = np.round(model.class_log_prior_ * scale).astype(np.int32)
    lb = LBModel(luts, bias_q, "argmax", action_bits, in_bits, scale,
                 n_classes=K)
    return _mapped("nb", lb)


def map_kmeans_lb(model, n_features: int, in_bits: int,
                  action_bits: int = 8,
                  feature_max: Optional[np.ndarray] = None) -> MappedModel:
    """Feature table f stores (v - c_f^k)^2; sqrt dropped (monotone)."""
    V = 2**in_bits
    C = model.cluster_centers_  # [K, F]
    vals = np.arange(V, dtype=np.float64)
    raw = (vals[None, :, None] - C.T[:, None, :]) ** 2  # [F, V, K]
    luts, scale = _quantize_tables(raw, action_bits, feature_max)
    lb = LBModel(
        luts, np.zeros(C.shape[0], np.int32), "argmin", action_bits, in_bits,
        scale, n_classes=C.shape[0],
    )
    return _mapped("kmeans", lb)


def map_pca_lb(model, n_features: int, in_bits: int,
               action_bits: int = 8,
               feature_max: Optional[np.ndarray] = None) -> MappedModel:
    """Feature table f stores (v - mean_f) * comp_f^j (paper Eq. 7)."""
    V = 2**in_bits
    vals = np.arange(V, dtype=np.float64)
    raw = np.einsum("fv,fj->fvj", vals[None, :] - model.mean_[:, None],
                    model.components_)
    luts, scale = _quantize_tables(raw, action_bits, feature_max)
    K = model.components_.shape[1]
    lb = LBModel(luts, np.zeros(K, np.int32), "raw", action_bits, in_bits, scale)
    return _mapped("pca", lb)


def map_ae_lb(model, n_features: int, in_bits: int,
              action_bits: int = 8,
              feature_max: Optional[np.ndarray] = None) -> MappedModel:
    """Single-layer encoder X_new = XW + B (paper Eq. 6)."""
    V = 2**in_bits
    vals = np.arange(V, dtype=np.float64)
    raw = np.einsum("v,fj->fvj", vals, model.W_)
    luts, scale = _quantize_tables(raw, action_bits, feature_max)
    bias_q = np.round(model.b_ * scale).astype(np.int32)
    lb = LBModel(luts, bias_q, "raw", action_bits, in_bits, scale)
    return _mapped("ae", lb)


def map_nb_joint_baseline(model, n_features: int, in_bits: int) -> int:
    """IIsy's joint-table NB baseline *entry count* (for Fig. 14a).

    The joint table is keyed by the full feature tuple — |V|^F entries —
    which is why the paper's log-domain upgrade exists.  We only account
    it (building it would be absurd, which is the point).
    """
    return (2**in_bits) ** n_features
