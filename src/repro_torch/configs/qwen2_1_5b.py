"""qwen2-1.5b [dense]: 28L d=1536 12H GQA(kv=2) d_ff=8960 vocab=151936.

GQA + QKV bias.  [arXiv:2407.10671; hf]
"""
from ..arch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536, n_heads=12,
    n_kv_heads=2, d_ff=8960, vocab_size=151936, head_dim=128, qkv_bias=True,
    rope_theta=1e6,
    notes="full attention -> long_500k skipped",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-1.5b-smoke", family="dense", n_layers=2, d_model=48,
        n_heads=3, n_kv_heads=1, d_ff=96, vocab_size=256, head_dim=16,
        qkv_bias=True,
    )
