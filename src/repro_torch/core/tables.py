"""Table artifacts: the deployable representation of a mapped ML model.

Planter maps trained models into match/action tables.  On the GPU the
tables become dense int arrays consumed by the kernels in
``repro_torch.kernels``:

* ``FeatureTable``     — exact-match value->code (EB) via split thresholds.
* ``LookupTable``      — exact-match value->vector of intermediate results (LB).
* ``TernaryTable``     — TCAM-style (value, mask, priority) -> action rows (EB
                         decision tables, KM/KNN quadtree cells).
* ``NodeTable``        — DM tree-walk tables (one per depth).
* ``PackedBnn``        — DM binarized-MLP weights, bit-packed into uint32.

Every artifact carries the paper's resource accounting: logical stages,
table entries and entry bits, so benchmarks can reproduce the paper's
entries/stages scalability analysis (Fig. 12/13) without hardware.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FeatureTable",
    "LookupTable",
    "TernaryTable",
    "NodeTable",
    "PackedBnn",
    "Resources",
    "range_to_ternary",
    "pack_codes",
    "pack_bits_uint32",
]


@dataclasses.dataclass(frozen=True)
class Resources:
    """Paper-style resource accounting (entries x bits, logical stages)."""

    stages: int
    entries: int
    entry_bits: int

    @property
    def table_bits(self) -> int:
        return self.entries * self.entry_bits

    def __add__(self, other: "Resources") -> "Resources":
        # Stages add sequentially; entries/bits accumulate.  Parallel tables
        # that share a stage must be merged before addition (see Pipeline).
        return Resources(
            stages=self.stages + other.stages,
            entries=self.entries + other.entries,
            entry_bits=max(self.entry_bits, other.entry_bits),
        )


@dataclasses.dataclass
class FeatureTable:
    """Exact-match feature table: raw value -> code (EB solutions).

    Realized as split thresholds per feature; code = number of thresholds
    <= value (i.e. ``searchsorted``).  On a switch this is a range/LPM
    table with ``len(thresholds)+1`` entries (with ternary range
    expansion it is entry-per-range); we account entries as ranges, the
    paper's optimized ternary encoding.
    """

    thresholds: np.ndarray  # [T] int64, sorted ascending
    in_bits: int  # width of the raw feature value

    def encode(self, values: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.thresholds, values, side="right").astype(
            np.int32
        )

    @property
    def n_codes(self) -> int:
        return len(self.thresholds) + 1

    def resources(self) -> Resources:
        # Ternary range expansion of [lo, hi] ranges: worst case 2*in_bits-2
        # entries per range, but contiguous code ranges aligned on split
        # points average far fewer; we count the tight prefix cover.
        entries = 0
        bounds = np.concatenate([[0], self.thresholds, [2**self.in_bits]])
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            entries += len(range_to_ternary(int(lo), int(hi) - 1, self.in_bits))
        code_bits = max(1, int(np.ceil(np.log2(max(2, self.n_codes)))))
        return Resources(stages=1, entries=entries,
                         entry_bits=2 * self.in_bits + code_bits)


@dataclasses.dataclass
class LookupTable:
    """Exact-match value -> vector of intermediate results (LB solutions).

    ``table[v, k]`` holds the quantized intermediate result of output
    dimension ``k`` for raw feature value ``v`` (paper Fig. 7).
    """

    table: np.ndarray  # [V, K] int32
    in_bits: int
    action_bits: int

    def lookup(self, values: np.ndarray) -> np.ndarray:
        return self.table[np.clip(values, 0, len(self.table) - 1)]

    def resources(self) -> Resources:
        v, k = self.table.shape
        return Resources(stages=1, entries=v,
                         entry_bits=self.in_bits + k * self.action_bits)


@dataclasses.dataclass
class TernaryTable:
    """TCAM-style table: (value, mask, priority) -> action.

    A key matches row i iff ``key & mask[i] == value[i]``.  The action of
    the highest-priority matching row wins; ``default_action`` otherwise
    (the paper's default-action upgrade that removes the most-common-label
    entries).  Keys wider than 32 bits are stored as multiple uint32 words
    (little-endian word order).
    """

    values: np.ndarray  # [N, W] uint32
    masks: np.ndarray  # [N, W] uint32
    priorities: np.ndarray  # [N] int32
    actions: np.ndarray  # [N] int32
    default_action: int
    key_bits: int

    @property
    def n_words(self) -> int:
        return self.values.shape[1] if self.values.ndim == 2 else 1

    def match(self, keys: np.ndarray) -> np.ndarray:
        """Reference (numpy) TCAM lookup. keys: [B, W] uint32."""
        if keys.ndim == 1:
            keys = keys[:, None]
        if len(self.values) == 0:
            return np.full(keys.shape[0], self.default_action, np.int32)
        hit = np.all(
            (keys[:, None, :] & self.masks[None]) == self.values[None], axis=-1
        )  # [B, N]
        prio = np.where(hit, self.priorities[None], -1)
        best = prio.argmax(axis=1)
        out = np.where(prio.max(axis=1) >= 0, self.actions[best], self.default_action)
        return out.astype(np.int32)

    def resources(self) -> Resources:
        action_bits = max(1, int(np.ceil(
            np.log2(max(2, self.actions.max(initial=0) + 2)))))
        return Resources(
            stages=1,
            entries=len(self.values),
            entry_bits=2 * self.key_bits + action_bits,
        )


@dataclasses.dataclass
class NodeTable:
    """DM tree-walk tables (pForest/SwitchTree style), one row per node.

    Row i: (feature[i], threshold[i], left[i], right[i], leaf_label[i]).
    Interior nodes have leaf_label = -1.  The walk needs ``depth`` lookups
    (= stages), matching the paper's stage-hungry DM accounting.
    """

    feature: np.ndarray  # [N] int32
    threshold: np.ndarray  # [N] int64
    left: np.ndarray  # [N] int32
    right: np.ndarray  # [N] int32
    leaf_label: np.ndarray  # [N] int32 (-1 interior)
    depth: int
    in_bits: int

    def walk(self, x: np.ndarray) -> np.ndarray:
        """Reference walk. x: [B, F] -> labels [B]."""
        node = np.zeros(x.shape[0], np.int32)
        for _ in range(self.depth + 1):
            leaf = self.leaf_label[node]
            feat = self.feature[node]
            go_right = x[np.arange(len(x)), feat] > self.threshold[node]
            nxt = np.where(go_right, self.right[node], self.left[node])
            node = np.where(leaf >= 0, node, nxt).astype(np.int32)
        return self.leaf_label[node]

    def resources(self) -> Resources:
        id_bits = max(1, int(np.ceil(np.log2(max(2, len(self.feature))))))
        # per paper: DM consumes a stage per depth level (compare + branch)
        return Resources(
            stages=self.depth,
            entries=len(self.feature),
            entry_bits=id_bits * 2 + self.in_bits + 8,
        )


@dataclasses.dataclass
class PackedBnn:
    """Bit-packed binarized MLP (DM BNN, XNOR-net style).

    layers[i] = (w_packed [N_out, W_words] uint32, n_in_bits) where each
    weight word packs 32 ±1 weights as bits (1 -> +1).  Forward:
    ``sign(2*popcount(XNOR(x, w)) - n_in)`` per the paper's Eq. 8.
    """

    layers: List[Tuple[np.ndarray, int]]

    def resources(self) -> Resources:
        entries = sum(int(w.size) for w, _ in self.layers)
        return Resources(stages=2 * len(self.layers), entries=entries, entry_bits=32)


def range_to_ternary(lo: int, hi: int, bits: int) -> List[Tuple[int, int]]:
    """Cover integer range [lo, hi] with (value, mask) ternary prefixes.

    Classic TCAM range expansion; returns the minimal prefix cover.  Used
    both for EB feature tables and for accounting (paper's exact-to-ternary
    ``Function`` module).
    """
    if lo > hi:
        return []
    out: List[Tuple[int, int]] = []
    full = (1 << bits) - 1
    while lo <= hi:
        # largest power-of-two block starting at lo that fits in [lo, hi]
        size = lo & -lo if lo > 0 else 1 << bits
        while lo + size - 1 > hi:
            size >>= 1
        span_bits = size.bit_length() - 1
        mask = (full >> span_bits) << span_bits & full
        out.append((lo & mask, mask))
        lo += size
    return out


def pack_codes(codes: np.ndarray, widths: Sequence[int]) -> np.ndarray:
    """Pack per-feature codes [B, F] into uint32 key words [B, W].

    Feature f occupies ``widths[f]`` bits; fields are laid out LSB-first in
    feature order across as many 32-bit words as needed.  Fields never
    straddle a word boundary (padded), mirroring how P4 lays out keys.
    """
    codes = np.asarray(codes, np.int64)
    offsets, word_idx = [], []
    word, bit = 0, 0
    for w in widths:
        if w > 32:
            raise ValueError("field wider than 32 bits")
        if bit + w > 32:
            word, bit = word + 1, 0
        offsets.append(bit)
        word_idx.append(word)
        bit += w
    n_words = word + 1
    out = np.zeros((codes.shape[0], n_words), np.uint32)
    for f, (off, wi, w) in enumerate(zip(offsets, word_idx, widths)):
        field = (codes[:, f] & ((1 << w) - 1)).astype(np.uint32)
        out[:, wi] |= field << off
    return out


def key_layout(widths: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Return [(word, offset, width)] per feature for ``pack_codes`` layout."""
    out: List[Tuple[int, int, int]] = []
    word, bit = 0, 0
    for w in widths:
        if bit + w > 32:
            word, bit = word + 1, 0
        out.append((word, bit, w))
        bit += w
    return out


def pack_bits_uint32(bits: np.ndarray) -> np.ndarray:
    """Pack a ±1/0-1 array [..., N] into uint32 words [..., ceil(N/32)].

    +1 (or 1) -> bit set; -1 (or 0) -> bit clear.  LSB-first within a word.
    """
    b = (np.asarray(bits) > 0).astype(np.uint8)
    n = b.shape[-1]
    pad = (-n) % 32
    if pad:
        b = np.concatenate([b, np.zeros(b.shape[:-1] + (pad,), np.uint8)], axis=-1)
    b = b.reshape(b.shape[:-1] + (-1, 32))
    shifts = np.arange(32, dtype=np.uint32)
    return (b.astype(np.uint32) << shifts).sum(axis=-1, dtype=np.uint32)
