"""Decision trees: CART classifier + second-order regression tree (for XGB).

Host-side training (the paper keeps training off the data plane).  Trees are
stored as flat arrays so mappers can consume them directly.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Tuple

import numpy as np

__all__ = ["DecisionTreeClassifier", "XGBRegressionTree", "TreeArrays"]


@dataclasses.dataclass
class TreeArrays:
    feature: np.ndarray  # [N] int32, -1 for leaf
    threshold: np.ndarray  # [N] int64 ("x <= thr" goes left)
    left: np.ndarray  # [N] int32
    right: np.ndarray  # [N] int32
    value: np.ndarray  # [N, K] float64 leaf value (class dist / score)
    depth: np.ndarray  # [N] int32

    @property
    def n_nodes(self) -> int:
        return len(self.feature)

    @property
    def max_depth(self) -> int:
        return int(self.depth.max(initial=0))

    def leaves(self) -> np.ndarray:
        return np.where(self.feature < 0)[0]

    def decision_path_apply(self, x: np.ndarray) -> np.ndarray:
        """Return leaf index per row."""
        node = np.zeros(len(x), np.int64)
        for _ in range(self.max_depth + 1):
            feat = self.feature[node]
            interior = feat >= 0
            if not interior.any():
                break
            go_left = x[np.arange(len(x)), np.maximum(feat, 0)] <= self.threshold[node]
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(interior, nxt, node)
        return node

    def leaf_boxes(self, n_features: int, lo: int, hi: int):
        """Yield (leaf_idx, box) with box[f] = [lo_f, hi_f] inclusive.

        Used by EB mappers: each leaf covers an axis-aligned box of raw
        feature space.
        """
        boxes = []

        def rec(node: int, box: np.ndarray):
            if self.feature[node] < 0:
                boxes.append((node, box.copy()))
                return
            f, t = int(self.feature[node]), int(self.threshold[node])
            lbox = box.copy()
            lbox[f, 1] = min(box[f, 1], t)
            rbox = box.copy()
            rbox[f, 0] = max(box[f, 0], t + 1)
            if lbox[f, 0] <= lbox[f, 1]:
                rec(int(self.left[node]), lbox)
            if rbox[f, 0] <= rbox[f, 1]:
                rec(int(self.right[node]), rbox)

        init = np.tile(np.array([[lo, hi]], np.int64), (n_features, 1))
        rec(0, init)
        return boxes


class _Builder:
    """Best-first CART builder with gini (classif.) or gain (xgb) splits."""

    def __init__(self, max_depth, min_samples_leaf, max_leaf_nodes, rng,
                 max_features=None):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_leaf_nodes = max_leaf_nodes
        self.rng = rng
        self.max_features = max_features
        self.nodes = []  # list of dict

    def _new_node(self, depth, value):
        self.nodes.append(
            dict(feature=-1, threshold=0, left=-1, right=-1, value=value, depth=depth)
        )
        return len(self.nodes) - 1

    def build(self, X, y_stats, split_fn, leaf_fn):
        """Generic best-first growth.

        split_fn(idx) -> (gain, feature, threshold, left_idx, right_idx) or None
        leaf_fn(idx) -> leaf value vector
        """
        root_idx = np.arange(len(X))
        root = self._new_node(0, leaf_fn(root_idx))
        heap = []
        counter = 0
        cand = split_fn(root_idx)
        if cand is not None:
            heapq.heappush(heap, (-cand[0], counter, root, root_idx, cand))
        n_leaves = 1
        while heap:
            if self.max_leaf_nodes is not None and n_leaves >= self.max_leaf_nodes:
                break
            _, _, node, idx, (gain, f, t, li, ri) = heapq.heappop(heap)
            depth = self.nodes[node]["depth"]
            lnode = self._new_node(depth + 1, leaf_fn(li))
            rnode = self._new_node(depth + 1, leaf_fn(ri))
            self.nodes[node].update(feature=f, threshold=t, left=lnode, right=rnode)
            n_leaves += 1
            for child, cidx in ((lnode, li), (rnode, ri)):
                if depth + 1 >= self.max_depth:
                    continue
                c = split_fn(cidx)
                if c is not None:
                    counter += 1
                    heapq.heappush(heap, (-c[0], counter, child, cidx, c))
        return self.arrays()

    def arrays(self) -> TreeArrays:
        n = len(self.nodes)
        K = len(np.atleast_1d(self.nodes[0]["value"]))
        out = TreeArrays(
            feature=np.array([d["feature"] for d in self.nodes], np.int32),
            threshold=np.array([d["threshold"] for d in self.nodes], np.int64),
            left=np.array([d["left"] for d in self.nodes], np.int32),
            right=np.array([d["right"] for d in self.nodes], np.int32),
            value=np.array([np.atleast_1d(d["value"])
                            for d in self.nodes]).reshape(n, K),
            depth=np.array([d["depth"] for d in self.nodes], np.int32),
        )
        return out

    def feature_subset(self, n_features):
        if self.max_features is None or self.max_features >= n_features:
            return np.arange(n_features)
        return self.rng.choice(n_features, self.max_features, replace=False)


class DecisionTreeClassifier:
    """CART with gini impurity on integer features."""

    def __init__(self, max_depth=4, min_samples_leaf=1, max_leaf_nodes=None,
                 max_features=None, seed=0):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_leaf_nodes = max_leaf_nodes
        self.max_features = max_features
        self.seed = seed
        self.tree_: Optional[TreeArrays] = None
        self.n_classes_ = 0

    def fit(self, X, y):
        X = np.asarray(X, np.int64)
        y = np.asarray(y, np.int64)
        self.n_classes_ = int(y.max()) + 1
        K = self.n_classes_
        b = _Builder(self.max_depth, self.min_samples_leaf, self.max_leaf_nodes,
                     np.random.default_rng(self.seed), self.max_features)

        def leaf_fn(idx):
            return np.bincount(y[idx], minlength=K).astype(np.float64)

        def gini(counts):
            tot = counts.sum()
            if tot == 0:
                return 0.0
            p = counts / tot
            return 1.0 - (p * p).sum()

        def split_fn(idx):
            if len(idx) < 2 * self.min_samples_leaf:
                return None
            Xi, yi = X[idx], y[idx]
            parent = np.bincount(yi, minlength=K).astype(np.float64)
            if (parent > 0).sum() <= 1:
                return None
            best = None
            for f in b.feature_subset(X.shape[1]):
                order = np.argsort(Xi[:, f], kind="stable")
                xv, yv = Xi[order, f], yi[order]
                onehot = np.zeros((len(yv), K))
                onehot[np.arange(len(yv)), yv] = 1.0
                cum = onehot.cumsum(axis=0)
                # candidate split after position i where value changes
                change = np.where(xv[:-1] != xv[1:])[0]
                for i in change:
                    nl = i + 1
                    nr = len(yv) - nl
                    if nl < self.min_samples_leaf or nr < self.min_samples_leaf:
                        continue
                    lc = cum[i]
                    rc = parent - lc
                    g = gini(parent) - (nl * gini(lc) + nr * gini(rc)) / len(yv)
                    if best is None or g > best[0]:
                        best = (g, f, int(xv[i]), order[: nl], order[nl:])
            if best is None or best[0] <= 1e-12:
                return None
            g, f, t, lo, ro = best
            return (g, f, t, idx[lo], idx[ro])

        self.tree_ = b.build(X, y, split_fn, leaf_fn)
        return self

    def predict(self, X):
        X = np.asarray(X, np.int64)
        leaves = self.tree_.decision_path_apply(X)
        return self.tree_.value[leaves].argmax(axis=1).astype(np.int64)

    def predict_proba(self, X):
        X = np.asarray(X, np.int64)
        leaves = self.tree_.decision_path_apply(X)
        v = self.tree_.value[leaves]
        return v / np.maximum(v.sum(axis=1, keepdims=True), 1e-12)


class XGBRegressionTree:
    """Second-order regression tree on (grad, hess) — XGBoost split gain."""

    def __init__(self, max_depth=4, min_samples_leaf=1, max_leaf_nodes=None,
                 reg_lambda=1.0, seed=0):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_leaf_nodes = max_leaf_nodes
        self.reg_lambda = reg_lambda
        self.seed = seed
        self.tree_: Optional[TreeArrays] = None

    def fit(self, X, grad, hess):
        X = np.asarray(X, np.int64)
        lam = self.reg_lambda
        b = _Builder(self.max_depth, self.min_samples_leaf, self.max_leaf_nodes,
                     np.random.default_rng(self.seed))

        def leaf_fn(idx):
            g, h = grad[idx].sum(), hess[idx].sum()
            return np.array([-g / (h + lam)])

        def score(g, h):
            return g * g / (h + lam)

        def split_fn(idx):
            if len(idx) < 2 * self.min_samples_leaf:
                return None
            Xi = X[idx]
            G, H = grad[idx].sum(), hess[idx].sum()
            best = None
            for f in range(X.shape[1]):
                order = np.argsort(Xi[:, f], kind="stable")
                xv = Xi[order, f]
                gc = grad[idx][order].cumsum()
                hc = hess[idx][order].cumsum()
                change = np.where(xv[:-1] != xv[1:])[0]
                for i in change:
                    nl = i + 1
                    if (nl < self.min_samples_leaf
                            or len(xv) - nl < self.min_samples_leaf):
                        continue
                    gain = (score(gc[i], hc[i])
                            + score(G - gc[i], H - hc[i]) - score(G, H))
                    if best is None or gain > best[0]:
                        best = (gain, f, int(xv[i]), order[: nl], order[nl:])
            if best is None or best[0] <= 1e-9:
                return None
            g, f, t, lo, ro = best
            return (g, f, t, idx[lo], idx[ro])

        self.tree_ = b.build(X, None, split_fn, leaf_fn)
        return self

    def predict(self, X):
        X = np.asarray(X, np.int64)
        leaves = self.tree_.decision_path_apply(X)
        return self.tree_.value[leaves, 0]
