"""Deterministic, shardable, resumable synthetic LM token pipeline.

Batches are a pure function of (seed, step), so a restarted/resharded job
replays the exact stream from its checkpointed step — the data-side half
of elastic fault tolerance.  Tokens follow a Zipfian marginal with a
planted bigram structure (so small-model training loss visibly drops).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # planted bigram: each token has a preferred successor
        self.succ = rng.permutation(V)
        ranks = np.arange(1, V + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.marginal = p / p.sum()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.choice(V, B, p=self.marginal)
        follow = rng.random((B, S)) < 0.5  # half the steps take the bigram
        fresh = rng.choice(V, (B, S), p=self.marginal)
        for t in range(1, S):
            toks[:, t] = np.where(follow[:, t], self.succ[toks[:, t - 1]],
                                  fresh[:, t])
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
