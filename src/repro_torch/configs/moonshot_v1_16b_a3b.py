"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H GQA(kv=16) expert_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight).

[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from ..arch.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=163840, head_dim=128,
    n_experts=64, n_experts_active=6,
    notes="full attention -> long_500k skipped",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="moonshot-smoke", family="moe", n_layers=2, d_model=32,
        n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16,
        n_experts=8, n_experts_active=2,
    )
