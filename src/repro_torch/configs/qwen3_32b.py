"""qwen3-32b [dense]: 64L d=5120 64H GQA(kv=8) d_ff=25600 vocab=151936.

qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]
"""
from ..arch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120, n_heads=64,
    n_kv_heads=8, d_ff=25600, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
    notes="full attention -> long_500k skipped (DESIGN.md §4)",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-32b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        qk_norm=True,
    )
