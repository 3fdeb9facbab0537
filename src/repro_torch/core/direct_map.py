"""Direct-mapping (DM) solutions — paper §4.3.

DM keeps the model's own structure in the pipeline: tree walks burn one
stage per depth level (pForest/SwitchTree), BNNs run as XNOR+popcount
layers (toNIC/N3IC).  Memory-light, stage-hungry — the paper's scalability
trade-off, which our stage accounting reproduces.

The BNN predictor runs the ``bnn_popcount_matmul`` kernel once per layer,
with the input bit packing, the sign and the repacking fused in;
the tree walk has no kernel (none in the JAX package either) and is a
plain-torch gather/compare loop on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels import ops
from ..ml.tree import TreeArrays
from .pipeline import MappedModel, Pipeline, Stage
from .tables import NodeTable, PackedBnn, pack_bits_uint32

# set bits of every byte value, for the numpy popcount
_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def _tree_to_node_table(tree: TreeArrays, in_bits: int) -> NodeTable:
    leaf_label = np.where(
        tree.feature < 0, tree.value.argmax(axis=1).astype(np.int32), -1
    )
    return NodeTable(
        feature=tree.feature.copy(),
        threshold=tree.threshold.copy(),
        left=tree.left.copy(),
        right=tree.right.copy(),
        leaf_label=leaf_label.astype(np.int32),
        depth=int(tree.max_depth),
        in_bits=in_bits,
    )


def _walk_torch(nt: NodeTable, device: torch.device) -> Callable:
    """The node walk of one tree: ``depth + 1`` gather/compare steps."""
    feature = torch.as_tensor(np.maximum(nt.feature, 0).astype(np.int64),
                              device=device)  # leaves: any valid column
    threshold = torch.as_tensor(nt.threshold.astype(np.int32), device=device)
    left = torch.as_tensor(nt.left.astype(np.int64), device=device)
    right = torch.as_tensor(nt.right.astype(np.int64), device=device)
    leaf = torch.as_tensor(nt.leaf_label.astype(np.int32), device=device)
    depth = nt.depth

    def walk(x: torch.Tensor) -> torch.Tensor:  # x: [B, F] int32
        node = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        for _ in range(depth + 1):
            xv = x.gather(1, feature[node][:, None])[:, 0]
            nxt = torch.where(xv <= threshold[node], left[node], right[node])
            node = torch.where(leaf[node] >= 0, node, nxt)
        return leaf[node]

    return walk


@dataclasses.dataclass
class DMForest:
    node_tables: List[NodeTable]
    n_classes: int
    combine: str  # 'single' | 'vote'

    def predict_np(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.int64)
        votes = np.stack([nt.walk(X) for nt in self.node_tables], axis=1)
        if self.combine == "single":
            return votes[:, 0]
        out = np.zeros(len(votes), np.int64)
        for i, v in enumerate(votes):
            out[i] = np.bincount(v, minlength=self.n_classes).argmax()
        return out

    def make_torch_fn(self, backend: str, device: torch.device) -> Callable:
        """Labels [B] int32 on ``device``.  DM has no custom kernel: the walk
        is gather/compare logic, which is exactly why the paper calls DM
        stage- and latency-hungry; ``"cuda"`` and ``"ref"`` both run it."""
        if backend not in ("cuda", "ref"):
            raise ValueError(f"backend {backend!r} is not a DM backend "
                             "('cuda' or 'ref')")
        walks = [_walk_torch(nt, device) for nt in self.node_tables]
        combine = self.combine
        classes = torch.arange(self.n_classes, device=device)

        def fn(x) -> torch.Tensor:
            x = torch.as_tensor(x).to(device=device, dtype=torch.int32)
            votes = torch.stack([w(x) for w in walks], dim=1)
            if combine == "single":
                return votes[:, 0]
            counts = (votes[:, :, None] == classes).sum(dim=1)
            return counts.argmax(dim=1).to(torch.int32)

        return fn

    def pipeline(self) -> Pipeline:
        # trees walk in parallel; stages = max depth (+1 vote logic)
        deepest = max(nt.depth for nt in self.node_tables)
        stages = [
            Stage("tree_walk", "walk", list(self.node_tables),
                  extra_stages=deepest - 1)
        ]
        if self.combine == "vote":
            stages.append(Stage("vote", "logic", []))
        return Pipeline(stages)


def dm_forest_from_arrays(node_tables: Sequence[dict], n_classes: int,
                          combine: str) -> DMForest:
    """A ``DMForest`` from plain arrays, one dict per tree with the
    ``NodeTable`` fields (``feature``, ``threshold``, ``left``, ``right``,
    ``leaf_label``, ``depth``, ``in_bits``), e.g. the JAX package's.
    ``_mapped(kind, forest)`` wraps it as a ``MappedModel``."""
    if combine not in ("single", "vote"):
        raise ValueError(f"combine {combine!r} not in ('single', 'vote')")
    tables = [NodeTable(
        feature=np.asarray(d["feature"], np.int32),
        threshold=np.asarray(d["threshold"], np.int64),
        left=np.asarray(d["left"], np.int32),
        right=np.asarray(d["right"], np.int32),
        leaf_label=np.asarray(d["leaf_label"], np.int32),
        depth=int(d["depth"]), in_bits=int(d["in_bits"]),
    ) for d in node_tables]
    return DMForest(tables, int(n_classes), combine)


def _mapped(kind: str, dm: Union[DMForest, "DMBnn"]) -> MappedModel:
    return MappedModel(kind, "dm", dm.pipeline(), dm.predict_np,
                       dm.make_torch_fn)


def map_dt_dm(model, n_features: int, in_bits: int) -> MappedModel:
    fr = DMForest([_tree_to_node_table(model.tree_, in_bits)],
                  model.n_classes_, "single")
    return _mapped("dt", fr)


def map_rf_dm(model, n_features: int, in_bits: int) -> MappedModel:
    fr = DMForest(
        [_tree_to_node_table(t.tree_, in_bits) for t in model.estimators_],
        model.n_classes_, "vote",
    )
    return _mapped("rf", fr)


def bnn_forward_np(x_packed: np.ndarray,
                   layers: Sequence[Tuple[np.ndarray, int]]) -> np.ndarray:
    """numpy DM-BNN forward (same arithmetic as ``ops.bnn_forward``):
    popcounts from a byte table over a ``uint8`` view of the XNOR words."""
    h = np.asarray(x_packed, np.uint32)
    for i, (w_packed, n_in) in enumerate(layers):
        w = np.asarray(w_packed, np.uint32)
        xnor = ~(h[:, None, :] ^ w[None, :, :])  # [B, N, W] uint32
        counts = _POP8[xnor.view(np.uint8)].sum(axis=-1, dtype=np.int64)
        dot = 2 * (counts - (32 * w.shape[1] - n_in)) - n_in
        if i == len(layers) - 1:
            return dot
        h = pack_bits_uint32(dot >= 0)
    raise ValueError("bnn_forward_np needs at least one layer")


@dataclasses.dataclass
class DMBnn:
    packed: PackedBnn
    in_bits: int
    n_features: int

    def _pack_input(self, X: np.ndarray) -> np.ndarray:
        shifts = np.arange(self.in_bits)
        bits = ((np.asarray(X, np.int64)[..., None] >> shifts) & 1).reshape(
            len(X), -1
        )
        return pack_bits_uint32(bits)

    def predict_np(self, X: np.ndarray) -> np.ndarray:
        scores = bnn_forward_np(self._pack_input(X), self.packed.layers)
        return scores.argmax(axis=1)

    def make_torch_fn(self, backend: str, device: torch.device) -> Callable:
        """Labels [B] int32 on ``device``: ``"cuda"`` runs one
        ``bnn_popcount_matmul`` launch per layer, the first packing the
        input bits itself, each hidden layer packing its signs and the last
        writing the scores (their plain versions on a CPU device); ``"ref"``
        runs the plain versions on any device.  The argmax is plain torch."""
        if backend not in ("cuda", "ref"):
            raise ValueError(f"backend {backend!r} is not a DM backend "
                             "('cuda' or 'ref')")
        layers = [(torch.as_tensor(np.ascontiguousarray(w, np.uint32)
                                   .view(np.int32), device=device), int(n_in))
                  for w, n_in in self.packed.layers]
        in_bits, plain = self.in_bits, backend == "ref"

        def fn(x) -> torch.Tensor:
            x = torch.as_tensor(x).to(device=device, dtype=torch.int32)
            scores = ops.bnn_forward(x.contiguous(), layers, plain=plain,
                                     in_bits=in_bits)
            return scores.argmax(dim=1).to(torch.int32)

        return fn

    def pipeline(self) -> Pipeline:
        return Pipeline([Stage("bnn", "bnn", [self.packed])])


def dm_bnn_from_arrays(layers: Sequence[Tuple[np.ndarray, int]],
                       in_bits: int = 8, n_features: int = 0) -> DMBnn:
    """A ``DMBnn`` from packed layers ``(w_packed [N, W] uint32, n_in)``,
    e.g. the JAX package's ``PackedBnn.layers``.  ``_mapped("bnn", bnn)``
    wraps it as a ``MappedModel``."""
    packed = PackedBnn([(np.asarray(w, np.uint32), int(n_in))
                        for w, n_in in layers])
    return DMBnn(packed, int(in_bits), int(n_features))


def map_bnn_dm(model, n_features: int, in_bits: int) -> MappedModel:
    """Binarize the trained MLP and bit-pack weights (paper Eq. 8)."""
    layers: List[Tuple[np.ndarray, int]] = []
    for w in model.binary_weights():  # [n_in, n_out] ±1
        layers.append((pack_bits_uint32(w.T), w.shape[0]))
    return _mapped("bnn", DMBnn(PackedBnn(layers), model.in_bits, n_features))
