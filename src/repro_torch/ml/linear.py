"""Linear models: OvO linear SVM, PCA, linear Autoencoder."""
from __future__ import annotations

from itertools import combinations
from typing import List, Tuple

import numpy as np

__all__ = ["LinearSVM", "PCA", "Autoencoder"]


class LinearSVM:
    """One-vs-one linear SVMs trained with Pegasos SGD (hinge + L2).

    k classes -> m = k(k-1)/2 hyperplanes (paper Eq. 2); prediction by
    pairwise voting, the same scheme the LB mapping implements on-device.
    """

    def __init__(self, epochs=40, reg=1e-4, seed=0):
        self.epochs = epochs
        self.reg = reg
        self.seed = seed
        self.pairs_: List[Tuple[int, int]] = []
        self.W_: np.ndarray = None  # [m, n]
        self.b_: np.ndarray = None  # [m]
        self.n_classes_ = 0

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.int64)
        self.n_classes_ = int(y.max()) + 1
        self.pairs_ = list(combinations(range(self.n_classes_), 2))
        scale = np.maximum(np.abs(X).max(axis=0), 1.0)
        Xs = X / scale  # scale-invariant training; fold back into W below
        rng = np.random.default_rng(self.seed)
        W = np.zeros((len(self.pairs_), X.shape[1]))
        b = np.zeros(len(self.pairs_))
        for m, (a, c) in enumerate(self.pairs_):
            mask = (y == a) | (y == c)
            Xi, yi = Xs[mask], np.where(y[mask] == a, 1.0, -1.0)
            if len(Xi) == 0:
                continue
            w = np.zeros(X.shape[1])
            bias = 0.0
            t = 0
            for ep in range(self.epochs):
                order = rng.permutation(len(Xi))
                for i in order:
                    t += 1
                    eta = 1.0 / (self.reg * t)
                    margin = yi[i] * (Xi[i] @ w + bias)
                    w *= 1 - eta * self.reg
                    if margin < 1:
                        w += eta * yi[i] * Xi[i]
                        bias += eta * yi[i] * 0.1
            W[m], b[m] = w / scale, bias
        self.W_, self.b_ = W, b
        return self

    def hyperplane_scores(self, X) -> np.ndarray:
        return np.asarray(X, np.float64) @ self.W_.T + self.b_

    def predict(self, X):
        s = self.hyperplane_scores(X)
        votes = np.zeros((len(s), self.n_classes_), np.int64)
        for m, (a, c) in enumerate(self.pairs_):
            votes[np.arange(len(s)), np.where(s[:, m] > 0, a, c)] += 1
        return votes.argmax(axis=1)


class PCA:
    def __init__(self, n_components=2):
        self.n_components = n_components
        self.mean_: np.ndarray = None
        self.components_: np.ndarray = None  # [n, m]

    def fit(self, X, y=None):
        X = np.asarray(X, np.float64)
        self.mean_ = X.mean(axis=0)
        _, _, vt = np.linalg.svd(X - self.mean_, full_matrices=False)
        self.components_ = vt[: self.n_components].T
        return self

    def transform(self, X):
        return (np.asarray(X, np.float64) - self.mean_) @ self.components_

    # alias so mappers can treat all models uniformly
    predict = transform


class Autoencoder:
    """Single-hidden-layer linear autoencoder (paper Eq. 6: X_new = XW + B).

    Only the encoder is mapped to the data plane; trained by full-batch
    gradient descent on reconstruction MSE.
    """

    def __init__(self, n_components=2, lr=0.01, epochs=50, seed=0):
        self.n_components = n_components
        self.lr = lr
        self.epochs = epochs
        self.seed = seed
        self.W_: np.ndarray = None  # [n, k]
        self.b_: np.ndarray = None  # [k]
        self.Wd_: np.ndarray = None

    def fit(self, X, y=None):
        X = np.asarray(X, np.float64)
        self.in_scale_ = np.maximum(np.abs(X).max(axis=0), 1.0)
        Xn = X / self.in_scale_
        n, k = X.shape[1], self.n_components
        rng = np.random.default_rng(self.seed)
        W = rng.normal(0, 0.1, (n, k))
        b = np.zeros(k)
        Wd = rng.normal(0, 0.1, (k, n))
        bd = np.zeros(n)
        m = len(X)
        for _ in range(self.epochs):
            H = Xn @ W + b
            R = H @ Wd + bd
            err = R - Xn  # [m, n]
            gWd = H.T @ err / m
            gbd = err.mean(axis=0)
            gH = err @ Wd.T
            gW = Xn.T @ gH / m
            gb = gH.mean(axis=0)
            W -= self.lr * gW
            b -= self.lr * gb
            Wd -= self.lr * gWd
            bd -= self.lr * gbd
        # fold input normalization into encoder weights
        self.W_ = W / self.in_scale_[:, None]
        self.b_ = b
        self.Wd_ = Wd
        return self

    def transform(self, X):
        return np.asarray(X, np.float64) @ self.W_ + self.b_

    predict = transform
