"""xlstm-125m [ssm]: 12L d=768 4H vocab=50304, sLSTM + mLSTM blocks.

d_ff=0: xLSTM blocks carry their own up-projection; no separate MLP.
Block pattern alternates mLSTM/sLSTM 1:1 (the 125M paper config mixes
both).  [arXiv:2405.04517; unverified]
"""
from ..arch.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    notes="recurrent -> long_500k RUNS",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m-smoke", family="ssm", n_layers=2, d_model=32,
        n_heads=2, n_kv_heads=2, d_ff=0, vocab_size=256,
        block_pattern=("mlstm", "slstm"),
    )
