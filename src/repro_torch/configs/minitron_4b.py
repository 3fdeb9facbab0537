"""minitron-4b [dense]: 32L d=3072 24H GQA(kv=8) d_ff=9216 vocab=256000.

Pruned Nemotron.  [arXiv:2407.14679; hf]
24 heads don't divide the 16-way model axis: attention TP shards the
fused head*dim projection axis instead (DESIGN.md §4).
"""
from ..arch.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072, n_heads=24,
    n_kv_heads=8, d_ff=9216, vocab_size=256000, head_dim=128,
    notes="full attention -> long_500k skipped",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="minitron-4b-smoke", family="dense", n_layers=2, d_model=48,
        n_heads=3, n_kv_heads=1, d_ff=96, vocab_size=256, head_dim=16,
    )
