"""internvl2-2b [vlm]: 24L d=2048 16H GQA(kv=8) d_ff=8192 vocab=92553
(padded to 92672).  InternViT frontend is a STUB (precomputed patch
embeddings) + InternLM2 backbone.  [arXiv:2404.16821; hf]
"""
from ..arch.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab_size=92553, head_dim=128,
    frontend="vit", frontend_dim=1024, frontend_seq=256,
    notes="full attention -> long_500k skipped",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-smoke", family="vlm", n_layers=2, d_model=32,
        n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=256, head_dim=16,
        frontend="vit", frontend_dim=32, frontend_seq=8,
    )
