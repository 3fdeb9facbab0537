"""Categorical Naive Bayes with Laplace smoothing (log-domain capable)."""
from __future__ import annotations

import numpy as np

__all__ = ["CategoricalNB"]


class CategoricalNB:
    """P(y | x) ∝ P(y) ∏ P(x_i | y) over integer-valued features.

    ``log_prob_tables()`` exposes log2 P(x_i=v | y) — the quantity the
    paper's upgraded LB mapping (Eq. 4) stores in feature tables to turn
    multiplication into addition.
    """

    def __init__(self, alpha=1.0):
        self.alpha = alpha
        self.class_log_prior_: np.ndarray = None  # [K] log2
        self.feature_log_prob_: list = None  # per feature [V_i, K] log2
        self.n_classes_ = 0
        self.n_values_: list = None

    def fit(self, X, y):
        X = np.asarray(X, np.int64)
        y = np.asarray(y, np.int64)
        K = self.n_classes_ = int(y.max()) + 1
        cls_count = np.bincount(y, minlength=K).astype(np.float64)
        self.class_log_prior_ = np.log2(cls_count / cls_count.sum())
        self.feature_log_prob_ = []
        self.n_values_ = []
        for f in range(X.shape[1]):
            V = int(X[:, f].max()) + 1
            self.n_values_.append(V)
            counts = np.zeros((V, K))
            np.add.at(counts, (X[:, f], y), 1.0)
            probs = (counts + self.alpha) / (cls_count[None] + self.alpha * V)
            self.feature_log_prob_.append(np.log2(probs))
        return self

    def joint_log2(self, X) -> np.ndarray:
        X = np.asarray(X, np.int64)
        out = np.tile(self.class_log_prior_, (len(X), 1))
        for f, tab in enumerate(self.feature_log_prob_):
            idx = np.clip(X[:, f], 0, tab.shape[0] - 1)
            out += tab[idx]
        return out

    def predict(self, X):
        return self.joint_log2(X).argmax(axis=1)
