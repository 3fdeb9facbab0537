"""N-gram next-token predictor — the serve-path draft model trainer.

The paper's pattern is: train a small model on the host, map it into
match/action lookup tables, and let the tables predict in the data
path at line rate.  ``NGramModel`` is that pattern pointed at token
streams: it counts ``context -> next token`` transitions (context =
the last ``order`` tokens, hashed for ``order > 1``) and its mapped
form (``serve.spec.compile_draft``) is a single exact-match
``LookupTable`` the fused serve step indexes to *draft* speculative
tokens.

``order=1`` (bigram) is the deployable configuration: the fused step
keeps exactly one token of rolling context per slot (``last``), so a
bigram table can be iterated ``k`` times per launch with pure gathers.
Higher orders train and predict on the host (useful for measuring how
much acceptance rate the deployable table leaves behind) but do not
compile to the in-step table.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["NGramModel"]

_MIX = np.uint64(0x9E3779B97F4A7C15)


def _fold_hash(ctx: np.ndarray) -> np.ndarray:
    """Order-preserving hash of integer context rows [..., n] -> uint64."""
    h = np.zeros(ctx.shape[:-1], np.uint64)
    for i in range(ctx.shape[-1]):
        h = (h ^ ctx[..., i].astype(np.uint64)) * _MIX
        h ^= h >> np.uint64(29)
    return h


class NGramModel:
    """Most-likely-next-token tables over hashed n-gram contexts.

    ``fit`` consumes token sequences (prompt + generated stream — the
    draft should imitate whatever the LM actually emits); ``predict``
    maps a batch of contexts ``[B, order]`` to the modal next token.
    Unseen contexts predict ``fallback`` (the globally most frequent
    token), which simply costs a rejected draft at serve time.
    """

    def __init__(self, order: int = 1, n_buckets: int = 0):
        if order < 1:
            raise ValueError(f"order must be >= 1, got {order}")
        self.order = int(order)
        self.n_buckets = int(n_buckets)  # 0 -> dense over vocab (order 1)
        self.vocab_size_ = 0
        self.table_: np.ndarray = None  # [n_entries] int32, -1 = unseen
        self.fallback_ = 0

    # ------------------------------------------------------------ train
    def _bucket(self, ctx: np.ndarray) -> np.ndarray:
        if self.order == 1 and not self.n_buckets:
            return ctx[..., 0].astype(np.int64)
        nb = self.n_buckets or 4096
        return (_fold_hash(ctx) % np.uint64(nb)).astype(np.int64)

    def fit(self, sequences: Sequence[Sequence[int]],
            vocab_size: int = 0) -> "NGramModel":
        seqs = [np.asarray(s, np.int64) for s in sequences if len(s) > 0]
        if not seqs:
            raise ValueError("no non-empty sequences to fit on")
        self.vocab_size_ = int(vocab_size or
                               max(int(s.max()) for s in seqs) + 1)
        V = self.vocab_size_
        n_entries = (V if self.order == 1 and not self.n_buckets
                     else (self.n_buckets or 4096))
        # the observed (bucket, next token) pairs and their counts, not a
        # dense [entries, V] count matrix: at an LM vocabulary (151,936
        # tokens) that matrix would take 184 GB
        total = np.zeros(V, np.int64)
        keys = []
        for s in seqs:
            total += np.bincount(s, minlength=V)
            if len(s) <= self.order:
                continue
            ctx = np.lib.stride_tricks.sliding_window_view(
                s[:-1], self.order)
            keys.append(self._bucket(ctx) * V + s[self.order:])
        self.fallback_ = int(total.argmax())
        self.table_ = np.full(n_entries, -1, np.int32)
        if keys:
            pair, cnt = np.unique(np.concatenate(keys), return_counts=True)
            bucket, tok = pair // V, pair % V
            # per bucket the most frequent next token, the lowest id on a
            # tie (the dense matrix's argmax)
            order = np.lexsort((tok, -cnt, bucket))
            first = np.ones(len(order), bool)
            first[1:] = bucket[order][1:] != bucket[order][:-1]
            pick = order[first]
            self.table_[bucket[pick]] = tok[pick].astype(np.int32)
        return self

    # ---------------------------------------------------------- predict
    def predict(self, contexts: np.ndarray) -> np.ndarray:
        """contexts [B, order] (or [B] for order 1) -> next tokens [B]."""
        ctx = np.asarray(contexts, np.int64)
        if ctx.ndim == 1:
            ctx = ctx[:, None]
        if ctx.shape[-1] != self.order:
            raise ValueError(
                f"expected context width {self.order}, got {ctx.shape[-1]}")
        b = np.clip(self._bucket(ctx), 0, len(self.table_) - 1)
        out = self.table_[b]
        return np.where(out >= 0, out, np.int32(self.fallback_))

    def hit_rate(self, sequences: Sequence[Sequence[int]]) -> float:
        """Fraction of next tokens this model predicts exactly — the
        upper bound on greedy speculative acceptance rate."""
        hits = tot = 0
        for s in sequences:
            s = np.asarray(s, np.int64)
            if len(s) <= self.order:
                continue
            ctx = np.lib.stride_tricks.sliding_window_view(
                s[:-1], self.order)
            pred = self.predict(ctx)
            hits += int((pred == s[self.order:]).sum())
            tot += len(pred)
        return hits / tot if tot else 0.0
