"""Ensemble trees: RandomForest, XGBoost (softmax boosting), IsolationForest."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .tree import DecisionTreeClassifier, XGBRegressionTree, TreeArrays

__all__ = ["RandomForestClassifier", "XGBoostClassifier", "IsolationForest"]


class RandomForestClassifier:
    def __init__(self, n_estimators=6, max_depth=4, max_leaf_nodes=None,
                 min_samples_leaf=1, bootstrap=True, seed=0):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.max_leaf_nodes = max_leaf_nodes
        self.min_samples_leaf = min_samples_leaf
        self.bootstrap = bootstrap
        self.seed = seed
        self.estimators_: List[DecisionTreeClassifier] = []
        self.n_classes_ = 0

    def fit(self, X, y):
        X = np.asarray(X, np.int64)
        y = np.asarray(y, np.int64)
        self.n_classes_ = int(y.max()) + 1
        rng = np.random.default_rng(self.seed)
        n = len(X)
        max_feat = max(1, int(np.sqrt(X.shape[1])))
        self.estimators_ = []
        for i in range(self.n_estimators):
            idx = rng.integers(0, n, n) if self.bootstrap else np.arange(n)
            t = DecisionTreeClassifier(
                max_depth=self.max_depth,
                min_samples_leaf=self.min_samples_leaf,
                max_leaf_nodes=self.max_leaf_nodes,
                max_features=max_feat,
                seed=self.seed + 1000 * i + 1,
            ).fit(X[idx], y[idx])
            # trees may not have seen every class; pad value columns
            if t.tree_.value.shape[1] < self.n_classes_:
                pad = self.n_classes_ - t.tree_.value.shape[1]
                t.tree_.value = np.pad(t.tree_.value, ((0, 0), (0, pad)))
                t.n_classes_ = self.n_classes_
            self.estimators_.append(t)
        return self

    def tree_votes(self, X) -> np.ndarray:
        """[B, n_trees] hard votes — matches the mapped voting-table path."""
        return np.stack([t.predict(X) for t in self.estimators_], axis=1)

    def predict(self, X):
        votes = self.tree_votes(X)
        out = np.zeros(len(votes), np.int64)
        for i, v in enumerate(votes):
            out[i] = np.bincount(v, minlength=self.n_classes_).argmax()
        return out


class XGBoostClassifier:
    """Gradient-boosted trees with softmax objective (one tree/class/round)."""

    def __init__(self, n_estimators=6, max_depth=4, max_leaf_nodes=None,
                 learning_rate=0.3, reg_lambda=1.0, seed=0):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.max_leaf_nodes = max_leaf_nodes
        self.learning_rate = learning_rate
        self.reg_lambda = reg_lambda
        self.seed = seed
        self.trees_: List[List[XGBRegressionTree]] = []  # [round][class]
        self.n_classes_ = 0
        self.base_score_ = 0.0

    def _softmax(self, logits):
        z = logits - logits.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)

    def fit(self, X, y):
        X = np.asarray(X, np.int64)
        y = np.asarray(y, np.int64)
        K = self.n_classes_ = int(y.max()) + 1
        n = len(X)
        logits = np.zeros((n, K))
        onehot = np.zeros((n, K))
        onehot[np.arange(n), y] = 1.0
        self.trees_ = []
        for r in range(self.n_estimators):
            p = self._softmax(logits)
            grad = p - onehot
            hess = np.maximum(p * (1 - p), 1e-6)
            round_trees = []
            for k in range(K):
                t = XGBRegressionTree(
                    max_depth=self.max_depth,
                    max_leaf_nodes=self.max_leaf_nodes,
                    reg_lambda=self.reg_lambda,
                    seed=self.seed + r * 131 + k,
                ).fit(X, grad[:, k], hess[:, k])
                logits[:, k] += self.learning_rate * t.predict(X)
                round_trees.append(t)
            self.trees_.append(round_trees)
        return self

    def decision_scores(self, X):
        X = np.asarray(X, np.int64)
        K = self.n_classes_
        logits = np.zeros((len(X), K))
        for round_trees in self.trees_:
            for k, t in enumerate(round_trees):
                logits[:, k] += self.learning_rate * t.predict(X)
        return logits

    def predict(self, X):
        return self.decision_scores(X).argmax(axis=1)


@dataclasses.dataclass
class _INode:
    feature: int
    threshold: int
    left: int
    right: int
    size: int  # for leaves: n samples; interior: -1
    depth: int


def _c_factor(n: int) -> float:
    """Average unsuccessful BST search length (Liu et al., Eq. in §4.1.4)."""
    if n <= 1:
        return 0.0
    if n == 2:
        return 1.0
    h = np.log(n - 1) + np.euler_gamma
    return 2.0 * h - 2.0 * (n - 1) / n


class IsolationForest:
    def __init__(self, n_estimators=3, max_samples=128, seed=0, contamination=0.5):
        self.n_estimators = n_estimators
        self.max_samples = max_samples
        self.seed = seed
        self.contamination = contamination
        self.trees_: List[List[_INode]] = []
        self.sample_size_ = 0
        self.threshold_ = 0.5

    def _build(self, X, rng, depth, max_depth) -> List[_INode]:
        nodes: List[_INode] = []

        def rec(idx, d):
            my = len(nodes)
            nodes.append(_INode(-1, 0, -1, -1, len(idx), d))
            if d >= max_depth or len(idx) <= 1:
                return my
            f = int(rng.integers(0, X.shape[1]))
            lo, hi = X[idx, f].min(), X[idx, f].max()
            if lo == hi:
                return my
            t = int(rng.integers(lo, hi))  # split: x <= t left
            li = idx[X[idx, f] <= t]
            ri = idx[X[idx, f] > t]
            l = rec(li, d + 1)
            r = rec(ri, d + 1)
            nodes[my] = _INode(f, t, l, r, -1, d)
            return my

        rec(np.arange(len(X)), 0)
        return nodes

    def fit(self, X, y=None):
        X = np.asarray(X, np.int64)
        rng = np.random.default_rng(self.seed)
        n = min(self.max_samples, len(X))
        self.sample_size_ = n
        max_depth = int(np.ceil(np.log2(max(2, n))))
        self.trees_ = []
        for _ in range(self.n_estimators):
            idx = rng.choice(len(X), n, replace=False)
            self.trees_.append(self._build(X[idx], rng, 0, max_depth))
        # calibrate decision threshold on training scores
        s = self.score_samples(X)
        self.threshold_ = float(np.quantile(s, 1.0 - self.contamination))
        return self

    def path_lengths(self, X) -> np.ndarray:
        """[B, n_trees] adjusted path length per tree."""
        X = np.asarray(X, np.int64)
        out = np.zeros((len(X), len(self.trees_)))
        for ti, nodes in enumerate(self.trees_):
            node = np.zeros(len(X), np.int64)
            done = np.zeros(len(X), bool)
            h = np.zeros(len(X))
            for _ in range(64):
                cur = [nodes[i] for i in node]
                feat = np.array([c.feature for c in cur])
                leaf = feat < 0
                newly = leaf & ~done
                if newly.any():
                    sz = np.array([c.size for c in cur])
                    dp = np.array([c.depth for c in cur])
                    h[newly] = dp[newly] + np.array([_c_factor(s) for s in sz[newly]])
                done |= leaf
                if done.all():
                    break
                thr = np.array([c.threshold for c in cur])
                lft = np.array([c.left for c in cur])
                rgt = np.array([c.right for c in cur])
                go_left = X[np.arange(len(X)), np.maximum(feat, 0)] <= thr
                node = np.where(done, node, np.where(go_left, lft, rgt))
            out[:, ti] = h
        return out

    def score_samples(self, X) -> np.ndarray:
        """Anomaly score in (0, 1); higher = more anomalous."""
        eh = self.path_lengths(X).mean(axis=1)
        c = _c_factor(self.sample_size_)
        return 2.0 ** (-eh / max(c, 1e-9))

    def predict(self, X):
        return (self.score_samples(X) >= self.threshold_).astype(np.int64)
