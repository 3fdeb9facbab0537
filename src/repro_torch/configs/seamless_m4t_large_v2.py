"""seamless-m4t-large-v2 [audio enc-dec]: 24L d=1024 16H d_ff=8192
vocab=256206 (padded to 256256 for even sharding).

Backbone only per spec: the speech frontend is a STUB — input_specs()
provides precomputed frame embeddings.  24 encoder + 24 decoder layers.
[arXiv:2308.11596; hf]
"""
from ..arch.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192, vocab_size=256206,
    n_encoder_layers=24, frontend="audio", frontend_dim=160,
    frontend_seq=4096,
    notes="enc-dec; decode shapes lower the text decoder; long_500k skipped",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="seamless-smoke", family="encdec", n_layers=2, d_model=32,
        n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=256,
        n_encoder_layers=2, frontend="audio", frontend_dim=16,
        frontend_seq=16,
    )
