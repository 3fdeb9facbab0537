"""Distance-based models: KMeans (Lloyd + kmeans++) and KNN classifier."""
from __future__ import annotations

import numpy as np

__all__ = ["KMeans", "KNeighborsClassifier"]


class KMeans:
    def __init__(self, n_clusters=3, n_iter=50, seed=0):
        self.n_clusters = n_clusters
        self.n_iter = n_iter
        self.seed = seed
        self.cluster_centers_: np.ndarray = None

    def fit(self, X, y=None):
        X = np.asarray(X, np.float64)
        rng = np.random.default_rng(self.seed)
        # kmeans++ init
        centers = [X[rng.integers(len(X))]]
        for _ in range(self.n_clusters - 1):
            d2 = np.min(
                ((X[:, None] - np.array(centers)[None]) ** 2).sum(-1), axis=1
            )
            p = d2 / max(d2.sum(), 1e-12)
            centers.append(X[rng.choice(len(X), p=p)])
        C = np.array(centers)
        for _ in range(self.n_iter):
            lab = ((X[:, None] - C[None]) ** 2).sum(-1).argmin(axis=1)
            newC = np.array(
                [X[lab == k].mean(axis=0) if (lab == k).any() else C[k]
                 for k in range(self.n_clusters)]
            )
            if np.allclose(newC, C):
                break
            C = newC
        self.cluster_centers_ = C
        return self

    def predict(self, X):
        X = np.asarray(X, np.float64)
        d2 = ((X[:, None] - self.cluster_centers_[None]) ** 2).sum(-1)
        return d2.argmin(axis=1)


class KNeighborsClassifier:
    def __init__(self, n_neighbors=5):
        self.n_neighbors = n_neighbors
        self.X_: np.ndarray = None
        self.y_: np.ndarray = None
        self.n_classes_ = 0

    def fit(self, X, y):
        self.X_ = np.asarray(X, np.float64)
        self.y_ = np.asarray(y, np.int64)
        self.n_classes_ = int(self.y_.max()) + 1
        return self

    def predict(self, X):
        X = np.asarray(X, np.float64)
        out = np.zeros(len(X), np.int64)
        for i in range(0, len(X), 1024):
            blk = X[i : i + 1024]
            d2 = ((blk[:, None] - self.X_[None]) ** 2).sum(-1)
            nn = np.argpartition(d2, min(self.n_neighbors, d2.shape[1] - 1), axis=1)[
                :, : self.n_neighbors
            ]
            for j, row in enumerate(nn):
                out[i + j] = np.bincount(
                    self.y_[row], minlength=self.n_classes_).argmax()
        return out
