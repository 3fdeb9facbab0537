"""Speculative-decoding draft models: Planter-mapped tables on the serve
hot path (mirrors ``repro.serve.spec``).

A host-trained bigram ``ml.NGramModel`` is mapped into an exact-match
``core.tables.LookupTable``; inside the fused device step the table drafts
``k`` tokens a decoding slot (``d_1 = T[last]``, ``d_{j+1} = T[d_j]``: ``k``
gathers from the dense ``[V]`` int32 successor table, ``device_table``) and
the LM verifies the chain in one chunked ``paged_decode_step(...,
all_positions=True)`` launch.  Only order 1 compiles: the step keeps one
token of context a slot.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.pipeline import MappedModel, Pipeline, Stage
from ..core.tables import LookupTable, Resources
from ..ml.ngram import NGramModel

__all__ = ["DraftModel", "compile_draft", "train_draft"]


@dataclasses.dataclass
class DraftModel:
    """A compiled (table-mapped) draft predictor: ``table.table[v, 0]`` is
    the drafted successor of token ``v``; ``mapped`` wraps it as a
    ``MappedModel`` (numpy reference, torch factory, resources)."""

    table: LookupTable
    mapped: MappedModel
    vocab_size: int
    meta: dict = dataclasses.field(default_factory=dict)

    def device_table(self, device: Union[str, torch.device]) -> torch.Tensor:
        """The dense ``[V]`` int32 successor table for the fused step."""
        return torch.as_tensor(self.table.table[:, 0].astype(np.int32),
                               device=device)

    def predict(self, tokens: np.ndarray) -> np.ndarray:
        return self.mapped.predict(np.asarray(tokens))

    def accounting(self) -> Resources:
        return self.mapped.resources()


def compile_draft(model: NGramModel,
                  vocab_size: Optional[int] = None) -> DraftModel:
    """Map a fitted bigram ``NGramModel`` into its lookup table; an unseen
    context drafts the model's fallback token (a wrong draft only costs a
    rejected chunk position)."""
    if model.order != 1 or model.n_buckets:
        raise ValueError(
            "only dense order-1 (bigram) n-gram models compile to the "
            f"in-step draft table (got order={model.order}, "
            f"n_buckets={model.n_buckets}); higher orders are host-only")
    if model.table_ is None:
        raise ValueError("model is not fitted")
    V = int(vocab_size or model.vocab_size_)
    tbl = np.full(V, model.fallback_, np.int32)
    n = min(V, len(model.table_))
    seen = model.table_[:n] >= 0
    tbl[:n] = np.where(seen, model.table_[:n], np.int32(model.fallback_))
    tbl = np.clip(tbl, 0, V - 1)
    bits = max(1, int(np.ceil(np.log2(max(2, V)))))
    lut = LookupTable(table=tbl[:, None], in_bits=bits, action_bits=bits)
    pipeline = Pipeline([Stage(name="draft_successor", kind="lut",
                               tables=[lut])])

    def predict_np(x: np.ndarray) -> np.ndarray:
        return lut.lookup(np.asarray(x, np.int64))[..., 0]

    def make_torch_fn(backend: str, device: torch.device):
        dev_tbl = torch.as_tensor(tbl, device=device)
        return lambda t: dev_tbl[t.clamp(0, V - 1).long()]

    mapped = MappedModel(
        model_kind="ngram", strategy="lb", pipeline=pipeline,
        predict_np=predict_np, make_torch_fn=make_torch_fn,
        meta={"order": 1, "vocab_size": V,
              "coverage": float(np.mean(model.table_ >= 0))
              if len(model.table_) else 0.0})
    return DraftModel(table=lut, mapped=mapped, vocab_size=V,
                      meta=dict(mapped.meta))


def train_draft(sequences: Sequence[Sequence[int]],
                vocab_size: int) -> DraftModel:
    """Fit and compile in one call: ``sequences`` are prompt + stream
    chains of the workload the draft will speculate on (the draft imitates
    the LM)."""
    model = NGramModel(order=1).fit(sequences, vocab_size=vocab_size)
    return compile_draft(model, vocab_size)
