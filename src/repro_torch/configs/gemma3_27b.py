"""gemma3-27b [dense]: 62L d=5376 32H GQA(kv=16) d_ff=21504 vocab=262144.

5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3 family; unverified]
"""
from ..arch.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense", n_layers=62, d_model=5376, n_heads=32,
    n_kv_heads=16, d_ff=21504, vocab_size=262144, head_dim=128, qk_norm=True,
    local_window=1024, global_every=6, rope_theta=1e6, act="gelu",
    notes="global layers are full attention -> long_500k skipped",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-27b-smoke", family="dense", n_layers=6, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        qk_norm=True, local_window=8, global_every=6, act="gelu",
    )
