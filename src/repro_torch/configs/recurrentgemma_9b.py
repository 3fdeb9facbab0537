"""recurrentgemma-9b [hybrid]: 38L d=4096 16H MQA(kv=1) d_ff=12288
vocab=256000.  RG-LRU + local attention, pattern (rec, rec, attn).

[arXiv:2402.19427; unverified]
"""
from ..arch.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab_size=256000, head_dim=256,
    local_window=2048, block_pattern=("rglru", "rglru", "attn"),
    act="gelu",
    notes="RG-LRU + windowed attn -> long_500k RUNS (state is O(1))",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-smoke", family="hybrid", n_layers=3, d_model=32,
        n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=256, head_dim=16,
        local_window=8, block_pattern=("rglru", "rglru", "attn"), act="gelu",
    )
