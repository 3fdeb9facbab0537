"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H GQA(kv=16) expert_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared experts.

60 experts pad to 64 for even 16-way expert parallelism; pad experts are
router-masked (DESIGN.md §4).  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from ..arch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=151936, head_dim=128,
    n_experts=60, n_experts_active=4, n_shared_experts=4,
    shared_d_ff=4 * 1408,
    notes="full attention -> long_500k skipped",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-smoke", family="moe", n_layers=2, d_model=32,
        n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16,
        n_experts=6, n_experts_active=2, n_shared_experts=1, shared_d_ff=64,
    )
