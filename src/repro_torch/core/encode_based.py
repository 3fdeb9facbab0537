"""Encode-based (EB) mapping — paper §4.1.

Feature tables slice raw feature space into per-feature *codes*; each
tree's leaves become ternary rows over the packed code key; ensemble
decisions are votes / quantized-score sums.  Includes the paper's two
upgrades over the IIsy baseline: ternary feature/decision tables (range
-> prefix cover) and default actions for the most-common label.

The predictors mirror the JAX package's: a staged one (``bucketize`` then
``ternary_match`` per table) and a fused one (one ``fused_eb`` launch per
table).  Code packing and the vote / sum / threshold combines are plain
torch, as they are plain jnp there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops, ref
from ..ml.forest import IsolationForest, _c_factor, _INode
from ..ml.tree import TreeArrays
from .pipeline import MappedModel, Pipeline, Stage
from .tables import (
    FeatureTable,
    TernaryTable,
    key_layout,
    pack_codes,
    range_to_ternary,
)

MAX_ENTRIES_PER_LEAF = 65536
INT32_MAX = np.iinfo(np.int32).max


# ----------------------------------------------------------------- helpers
def build_feature_tables(
    trees: Sequence[TreeArrays], n_features: int, in_bits: int
) -> List[FeatureTable]:
    """Collect split thresholds per feature across all trees (paper:
    "Find feature splits").  Stored as (t+1) so that code(x) = #{thr <= x}
    puts x == t on the left side of an "x <= t" split."""
    splits: List[set] = [set() for _ in range(n_features)]
    for t in trees:
        for node in range(t.n_nodes):
            f = int(t.feature[node])
            if f >= 0:
                splits[f].add(int(t.threshold[node]) + 1)
    return [
        FeatureTable(np.array(sorted(s), np.int64), in_bits) for s in splits
    ]


def _code_widths(ftables: Sequence[FeatureTable]) -> List[int]:
    return [max(1, int(np.ceil(np.log2(max(2, ft.n_codes))))) for ft in ftables]


def _unsorted_rows(rows: Sequence[np.ndarray]) -> List[int]:
    return [f for f, r in enumerate(rows) if np.any(np.diff(r) < 0)]


def _thresholds_matrix(ftables: Sequence[FeatureTable]) -> np.ndarray:
    """[F, T] int32 padded with INT32_MAX for the bucketize kernel, which
    binary-searches non-decreasing rows (it compare-counts any other, more
    slowly): every row is checked sorted here, once."""
    T = max(1, max(len(ft.thresholds) for ft in ftables))
    out = np.full((len(ftables), T), INT32_MAX, np.int32)
    for f, ft in enumerate(ftables):
        out[f, : len(ft.thresholds)] = ft.thresholds
    bad = _unsorted_rows(out)
    if bad:
        raise ValueError(f"threshold rows {bad} are not non-decreasing "
                         "(as int32): bucketize needs sorted rows")
    return out


def _leaf_ternary_rows(
    tree: TreeArrays,
    ftables: Sequence[FeatureTable],
    in_bits: int,
    action_of_leaf: Callable[[int], int],
    default_action: int,
) -> TernaryTable:
    """Leaf boxes -> prefix-cover ternary rows over the packed code key."""
    widths = _code_widths(ftables)
    layout = key_layout(widths)
    n_words = max(w for w, _, _ in layout) + 1
    values, masks, actions = [], [], []
    for leaf, box in tree.leaf_boxes(len(ftables), 0, 2**in_bits - 1):
        act = action_of_leaf(leaf)
        if act == default_action:
            continue  # paper's default-action upgrade
        per_feature: List[List[Tuple[int, int]]] = []
        for f, ft in enumerate(ftables):
            clo = int(ft.encode(np.array([box[f, 0]]))[0])
            chi = int(ft.encode(np.array([box[f, 1]]))[0])
            per_feature.append(range_to_ternary(clo, chi, widths[f]))
        n_rows = int(np.prod([len(p) for p in per_feature]))
        if n_rows > MAX_ENTRIES_PER_LEAF:
            raise ValueError(f"leaf expands to {n_rows} ternary rows")
        # cross product of per-feature prefixes
        combos = [([], [])]
        for p in per_feature:
            combos = [
                (vs + [v], ms + [m]) for (vs, ms) in combos for (v, m) in p
            ]
        for vs, ms in combos:
            vw = np.zeros(n_words, np.uint64)
            mw = np.zeros(n_words, np.uint64)
            for f, (word, off, width) in enumerate(layout):
                vw[word] |= np.uint64(vs[f]) << np.uint64(off)
                mw[word] |= np.uint64(ms[f]) << np.uint64(off)
            values.append(vw)
            masks.append(mw)
            actions.append(act)
    n = len(values)
    return TernaryTable(
        values=np.array(values, np.uint64).astype(np.uint32).reshape(n, n_words)
        if n
        else np.zeros((0, n_words), np.uint32),
        masks=np.array(masks, np.uint64).astype(np.uint32).reshape(n, n_words)
        if n
        else np.zeros((0, n_words), np.uint32),
        priorities=np.arange(n, dtype=np.int32),
        actions=np.array(actions, np.int32),
        default_action=default_action,
        key_bits=sum(widths),
    )


def _prio_action(tbl: TernaryTable) -> np.ndarray:
    if tbl.actions.max(initial=0) >= 256 or tbl.actions.min(initial=0) < 0:
        raise ValueError("actions must fit 8 bits")
    return (tbl.priorities * 256 + tbl.actions).astype(np.int32)


# ------------------------------------------------------------ EB ensemble
@dataclasses.dataclass
class EBTreeEnsemble:
    """Shared runtime for all EB tree-family mappings."""

    ftables: List[FeatureTable]
    tables: List[TernaryTable]
    in_bits: int
    combine: str  # 'single' | 'vote' | 'sum_argmax' | 'sum_threshold'
    n_classes: int
    tree_class: Optional[np.ndarray] = None  # [n_tables] class of each table (xgb)
    sum_threshold: float = 0.0  # iforest: anomaly if sum <= threshold
    dequant: Tuple[float, float] = (1.0, 0.0)  # score = a*q + b

    @property
    def widths(self) -> List[int]:
        return _code_widths(self.ftables)

    def encode_np(self, X: np.ndarray) -> np.ndarray:
        codes = np.stack(
            [ft.encode(X[:, f]) for f, ft in enumerate(self.ftables)], axis=1
        )
        return codes

    def actions_np(self, X: np.ndarray) -> np.ndarray:
        keys = pack_codes(self.encode_np(X), self.widths)
        return np.stack([t.match(keys) for t in self.tables], axis=1)

    def _combine_np(self, acts: np.ndarray) -> np.ndarray:
        if self.combine == "single":
            return acts[:, 0]
        if self.combine == "vote":
            out = np.zeros(len(acts), np.int64)
            for i, v in enumerate(acts):
                out[i] = np.bincount(v, minlength=self.n_classes).argmax()
            return out
        a, b = self.dequant
        scores = a * acts + b
        if self.combine == "sum_threshold":
            return (scores.sum(axis=1) <= self.sum_threshold).astype(np.int64)
        # sum_argmax (xgb): accumulate per class
        logits = np.zeros((len(acts), self.n_classes))
        for t in range(acts.shape[1]):
            logits[:, self.tree_class[t]] += scores[:, t]
        return logits.argmax(axis=1)

    def predict_np(self, X: np.ndarray) -> np.ndarray:
        return self._combine_np(self.actions_np(np.asarray(X, np.int64)))

    @property
    def identity(self) -> bool:
        """KM/KNN quadtree tables: the raw quantized values are the codes."""
        return all(len(ft.thresholds) == 0 for ft in self.ftables)

    def device_tables(self, dev: torch.device):
        """Thresholds and per-table (values, masks, prio_action, default) on
        ``dev``, uint32 words as int32 bit patterns."""
        thr = torch.as_tensor(_thresholds_matrix(self.ftables), device=dev)
        tbls = [
            (torch.as_tensor(t.values.view(np.int32), device=dev),
             torch.as_tensor(t.masks.view(np.int32), device=dev),
             torch.as_tensor(_prio_action(t), device=dev),
             int(t.default_action))
            for t in self.tables
        ]
        return thr, tbls

    def make_torch_fn(self, backend: str, device: torch.device) -> Callable:
        """Predictor ``x [B, F] -> labels [B] int32`` on ``device``.

        ``"ref"`` runs the kernels' plain versions, ``"cuda"`` the staged
        kernels and ``"cuda_fused"`` the fused one; on a CPU device the two
        kernel backends dispatch to the same plain versions.
        """
        if backend == "cuda_fused":
            return self._make_fused_fn(device)
        if backend == "ref":
            bucketize, match = ref.bucketize_ref, ref.ternary_match_ref
        elif backend == "cuda":
            bucketize, match = ops.bucketize, ops.ternary_match
        else:
            raise ValueError(f"unknown backend {backend!r}")
        thr, tbls = self.device_tables(device)
        layout = key_layout(self.widths)
        n_words = max(w for w, _, _ in layout) + 1
        identity = self.identity

        def fn(x) -> torch.Tensor:
            x = torch.as_tensor(x).to(device=device, dtype=torch.int32)
            codes = x if identity else bucketize(x, thr)
            keys = ref.pack_codes_ref(codes, layout, n_words)
            acts = torch.stack([match(keys, v, m, pa, d)
                                for (v, m, pa, d) in tbls], dim=1)
            return self._combine_torch(acts)

        return fn

    def _make_fused_fn(self, device: torch.device) -> Callable:
        """One fused launch per table: encode + pack + match."""
        thr, tbls = self.device_tables(device)
        layout = torch.as_tensor(key_layout(self.widths), dtype=torch.int32,
                                 device=device).reshape(-1, 3)
        identity = self.identity

        def fn(x) -> torch.Tensor:
            x = torch.as_tensor(x).to(device=device, dtype=torch.int32)
            acts = torch.stack([
                ops.fused_eb_match(x, thr, v, m, pa, layout, d,
                                   identity=identity)
                for (v, m, pa, d) in tbls
            ], dim=1)
            return self._combine_torch(acts)

        return fn

    def _combine_torch(self, acts: torch.Tensor) -> torch.Tensor:
        """Per-table actions [B, n_tables] -> labels [B] int32.

        Float sums run tree by tree, left to right, so the order does not
        depend on the device or on a library's reduction blocking.
        """
        if self.combine == "single":
            return acts[:, 0]
        if self.combine == "vote":
            classes = torch.arange(self.n_classes, dtype=acts.dtype,
                                   device=acts.device)
            counts = (acts[:, :, None] == classes).sum(dim=1)
            return counts.argmax(dim=1).to(torch.int32)
        a, b = self.dequant
        scores = acts.to(torch.float32) * a + b
        if self.combine == "sum_threshold":
            total = scores[:, 0]
            for t in range(1, scores.shape[1]):
                total = total + scores[:, t]
            return (total <= self.sum_threshold).to(torch.int32)
        logits = torch.zeros((acts.shape[0], self.n_classes),
                             dtype=torch.float32, device=acts.device)
        for t, k in enumerate(self.tree_class.tolist()):
            logits[:, k] += scores[:, t]
        return logits.argmax(dim=1).to(torch.int32)

    def pipeline(self) -> Pipeline:
        stages = []
        if not self.identity:
            stages.append(Stage("feature_tables", "feature", list(self.ftables)))
        stages.append(Stage("code_tables", "ternary", list(self.tables)))
        if self.combine != "single":
            stages.append(Stage("decision", "logic", []))
        return Pipeline(stages)


def eb_ensemble_from_arrays(d: Dict[str, Any]) -> EBTreeEnsemble:
    """Build an ``EBTreeEnsemble`` from plain numpy arrays.

    With it the port predicts with exactly the tables another builder (the
    JAX package) made.  ``d`` holds:

    * ``thresholds``: one sorted int array per feature (all empty for the
      KM/KNN identity encoding; an unsorted one raises ``ValueError``) and
      ``in_bits``;
    * ``tables``: one dict per table with ``values`` and ``masks``
      ([N, W] uint32), ``priorities``, ``actions`` ([N] int32) and
      ``default_action``;
    * ``combine``, ``n_classes`` and, where the combine needs them,
      ``tree_class``, ``sum_threshold`` and ``dequant``.

    ``_mapped(kind, ensemble)`` wraps the result as a ``MappedModel``.
    """
    in_bits = int(d["in_bits"])
    thresholds = [np.asarray(t, np.int64) for t in d["thresholds"]]
    bad = _unsorted_rows(thresholds)
    if bad:
        raise ValueError(f"thresholds of features {bad} are not sorted")
    if all(len(t) == 0 for t in thresholds):
        ftables = _identity_ftables(len(thresholds), in_bits)
    else:
        ftables = [FeatureTable(t, in_bits) for t in thresholds]
    widths = _code_widths(ftables)
    n_words = max(w for w, _, _ in key_layout(widths)) + 1
    tables = []
    for t in d["tables"]:
        tables.append(TernaryTable(
            values=np.asarray(t["values"], np.uint32).reshape(-1, n_words),
            masks=np.asarray(t["masks"], np.uint32).reshape(-1, n_words),
            priorities=np.asarray(t["priorities"], np.int32),
            actions=np.asarray(t["actions"], np.int32),
            default_action=int(t["default_action"]),
            key_bits=sum(widths),
        ))
    tree_class = d.get("tree_class")
    return EBTreeEnsemble(
        ftables, tables, in_bits, d["combine"], int(d["n_classes"]),
        tree_class=None if tree_class is None else np.asarray(tree_class,
                                                              np.int32),
        sum_threshold=float(d.get("sum_threshold", 0.0)),
        dequant=tuple(float(v) for v in d.get("dequant", (1.0, 0.0))),
    )


def _mapped(kind: str, ens: EBTreeEnsemble, meta=None) -> MappedModel:
    return MappedModel(
        model_kind=kind,
        strategy="eb",
        pipeline=ens.pipeline(),
        predict_np=ens.predict_np,
        make_torch_fn=ens.make_torch_fn,
        meta=meta or {},
    )


# ------------------------------------------------------------- per model
def map_dt_eb(model, n_features: int, in_bits: int) -> MappedModel:
    tree: TreeArrays = model.tree_
    ftables = build_feature_tables([tree], n_features, in_bits)
    default = int(tree.value.sum(axis=0).argmax())
    tbl = _leaf_ternary_rows(
        tree, ftables, in_bits,
        lambda leaf: int(tree.value[leaf].argmax()), default,
    )
    ens = EBTreeEnsemble(ftables, [tbl], in_bits, "single", model.n_classes_)
    return _mapped("dt", ens)


def map_rf_eb(model, n_features: int, in_bits: int) -> MappedModel:
    trees = [t.tree_ for t in model.estimators_]
    ftables = build_feature_tables(trees, n_features, in_bits)
    tables = []
    for t in trees:
        default = int(t.value.sum(axis=0).argmax())
        tables.append(
            _leaf_ternary_rows(
                t, ftables, in_bits,
                lambda leaf, t=t: int(t.value[leaf].argmax()), default,
            )
        )
    ens = EBTreeEnsemble(ftables, tables, in_bits, "vote", model.n_classes_)
    return _mapped("rf", ens)


def map_xgb_eb(model, n_features: int, in_bits: int,
               score_bits: int = 8) -> MappedModel:
    trees, tree_class = [], []
    for round_trees in model.trees_:
        for k, t in enumerate(round_trees):
            trees.append(t.tree_)
            tree_class.append(k)
    ftables = build_feature_tables(trees, n_features, in_bits)
    # global quantization of lr * leaf values to score_bits
    leaf_vals = np.concatenate(
        [model.learning_rate * t.value[t.leaves(), 0] for t in trees]
    )
    lo, hi = float(leaf_vals.min()), float(leaf_vals.max())
    span = max(hi - lo, 1e-9)
    qmax = 2**score_bits - 1

    def quant(v: float) -> int:
        return int(round((v - lo) / span * qmax))

    tables = []
    for t in trees:
        leaf_q = {
            int(l): quant(model.learning_rate * float(t.value[l, 0]))
            for l in t.leaves()
        }
        counts = np.bincount(list(leaf_q.values()), minlength=qmax + 1)
        default = int(counts.argmax())
        tables.append(
            _leaf_ternary_rows(t, ftables, in_bits, lambda l: leaf_q[int(l)], default)
        )
    ens = EBTreeEnsemble(
        ftables, tables, in_bits, "sum_argmax", model.n_classes_,
        tree_class=np.array(tree_class, np.int32),
        dequant=(span / qmax, lo),
    )
    return _mapped("xgb", ens, {"score_bits": score_bits})


def _inode_to_arrays(nodes: List[_INode]) -> TreeArrays:
    n = len(nodes)
    feature = np.array([nd.feature for nd in nodes], np.int32)
    value = np.zeros((n, 1))
    for i, nd in enumerate(nodes):
        if nd.feature < 0:
            value[i, 0] = nd.depth + _c_factor(nd.size)
    return TreeArrays(
        feature=feature,
        threshold=np.array([nd.threshold for nd in nodes], np.int64),
        left=np.array([nd.left for nd in nodes], np.int32),
        right=np.array([nd.right for nd in nodes], np.int32),
        value=value,
        depth=np.array([nd.depth for nd in nodes], np.int32),
    )


def map_iforest_eb(model: IsolationForest, n_features: int, in_bits: int,
                   score_bits: int = 8) -> MappedModel:
    trees = [_inode_to_arrays(t) for t in model.trees_]
    ftables = build_feature_tables(trees, n_features, in_bits)
    all_h = np.concatenate([t.value[t.leaves(), 0] for t in trees])
    lo, hi = float(all_h.min()), float(all_h.max())
    span = max(hi - lo, 1e-9)
    qmax = 2**score_bits - 1
    tables = []
    for t in trees:
        leaf_q = {
            int(l): int(round((float(t.value[l, 0]) - lo) / span * qmax))
            for l in t.leaves()
        }
        counts = np.bincount(list(leaf_q.values()), minlength=qmax + 1)
        default = int(counts.argmax())
        tables.append(
            _leaf_ternary_rows(t, ftables, in_bits, lambda l: leaf_q[int(l)], default)
        )
    # anomaly iff E[h] <= -log2(threshold) * c(n)  (paper Eq. 1)
    c = _c_factor(model.sample_size_)
    h_thresh_total = -np.log2(max(model.threshold_, 1e-9)) * c * len(trees)
    ens = EBTreeEnsemble(
        ftables, tables, in_bits, "sum_threshold", 2,
        sum_threshold=float(h_thresh_total), dequant=(span / qmax, lo),
    )
    return _mapped("iforest", ens, {"score_bits": score_bits})


# ----------------------------------------------- KM / KNN quadtree encode
def _quadtree_rows(
    label_fn: Callable[[np.ndarray], np.ndarray],
    n_features: int,
    in_bits: int,
    max_depth: int,
) -> TernaryTable:
    """Recursive 2^n-tree cell labeling (Clustreams-style, paper §4.1.5).

    ``label_fn(points [M, F]) -> labels [M]``.  A cell is emitted when all
    its corners (plus center) agree or max depth is reached.
    """
    values, masks, actions = [], [], []
    layout = key_layout([in_bits] * n_features)
    n_words = max(w for w, _, _ in layout) + 1
    corner_grid = np.array(
        np.meshgrid(*[[0, 1]] * n_features, indexing="ij")
    ).reshape(n_features, -1).T  # [2^F, F]

    def emit(prefix: np.ndarray, depth: int, label: int):
        shift = in_bits - depth
        vw = np.zeros(n_words, np.uint64)
        mw = np.zeros(n_words, np.uint64)
        field_mask = (((1 << depth) - 1) << shift) & ((1 << in_bits) - 1)
        for f, (word, off, width) in enumerate(layout):
            vw[word] |= np.uint64(int(prefix[f]) << shift) << np.uint64(off)
            mw[word] |= np.uint64(field_mask) << np.uint64(off)
        values.append(vw)
        masks.append(mw)
        actions.append(label)

    def rec(prefix: np.ndarray, depth: int):
        shift = in_bits - depth
        lo = prefix << shift
        hi = lo + (1 << shift) - 1
        corners = lo[None, :] + corner_grid * (hi - lo)[None, :]
        center = (lo + hi) // 2
        pts = np.vstack([corners, center[None]])
        labels = label_fn(pts)
        if depth >= max_depth or np.all(labels == labels[0]):
            emit(prefix, depth, int(labels[-1]))
            return
        for child in corner_grid:
            rec(prefix * 2 + child, depth + 1)

    rec(np.zeros(n_features, np.int64), 0)
    n = len(values)
    return TernaryTable(
        values=np.array(values, np.uint64).astype(np.uint32).reshape(n, n_words),
        masks=np.array(masks, np.uint64).astype(np.uint32).reshape(n, n_words),
        priorities=np.arange(n, dtype=np.int32),
        actions=np.array(actions, np.int32),
        default_action=0,
        key_bits=in_bits * n_features,
    )


def _identity_ftables(n_features: int, in_bits: int) -> List[FeatureTable]:
    # raw quantized values ARE the codes; widths forced to in_bits by the
    # quadtree layout (no thresholds -> n_codes==1, so override widths).
    class _IdTable(FeatureTable):
        @property
        def n_codes(self):  # type: ignore[override]
            return 2**self.in_bits

        def encode(self, values):  # identity: raw value is the code
            return np.asarray(values, np.int32)

        def resources(self):
            from .tables import Resources
            return Resources(stages=0, entries=0, entry_bits=0)

    return [_IdTable(np.array([], np.int64), in_bits) for _ in range(n_features)]


def map_kmeans_eb(model, n_features: int, in_bits: int,
                  max_depth: int = 3) -> MappedModel:
    centers = model.cluster_centers_

    def label_fn(pts):
        d2 = ((pts[:, None, :] - centers[None]) ** 2).sum(-1)
        return d2.argmin(axis=1)

    tbl = _quadtree_rows(label_fn, n_features, in_bits, max_depth)
    ens = EBTreeEnsemble(
        _identity_ftables(n_features, in_bits), [tbl], in_bits, "single",
        len(centers),
    )
    return _mapped("kmeans", ens, {"max_depth": max_depth})


def map_knn_eb(model, n_features: int, in_bits: int,
               max_depth: int = 3) -> MappedModel:
    tbl = _quadtree_rows(
        lambda pts: model.predict(pts), n_features, in_bits, max_depth
    )
    ens = EBTreeEnsemble(
        _identity_ftables(n_features, in_bits), [tbl], in_bits, "single",
        model.n_classes_,
    )
    return _mapped("knn", ens, {"max_depth": max_depth})


