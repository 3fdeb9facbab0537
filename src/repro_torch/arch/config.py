"""Architecture + shape configs for the assigned-architecture pool."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # sliding-window pattern: every `global_every`-th layer is global
    # (gemma3: 6 -> 5 local : 1 global); 0 = all layers global.
    local_window: int = 0
    global_every: int = 0
    # recurrent block pattern, cycled (hybrid/ssm): e.g. ('rglru','rglru','attn')
    block_pattern: Tuple[str, ...] = ()
    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    # enc-dec
    n_encoder_layers: int = 0
    # modality frontend stub
    frontend: str = ""  # '' | 'vit' | 'audio'
    frontend_dim: int = 0
    frontend_seq: int = 0  # patches/frames contributed to the sequence
    norm_eps: float = 1e-6
    act: str = "silu"
    notes: str = ""
    # §Perf lever: pad query heads to a multiple of the TP degree so the
    # head dim shards evenly (minitron 24H->32, qwen2 12H->16).  Pad heads
    # have zeroed wq columns / wo rows, so outputs are bit-identical.
    pad_q_heads: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_heads(self) -> int:
        if self.pad_q_heads and self.n_heads % 16:
            return _round_up(self.n_heads, 16)
        return self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to 256 so the embedding shards evenly (DESIGN §4)."""
        return _round_up(self.vocab_size, 256)

    @property
    def n_experts_padded(self) -> int:
        """Experts rounded to 16 for even EP (qwen2-moe: 60 -> 64)."""
        return _round_up(self.n_experts, 16) if self.n_experts else 0

    @property
    def is_subquadratic(self) -> bool:
        """Archs that run long_500k: recurrent state + at most local attn."""
        if not self.block_pattern:
            return False
        return "attn_global" not in self.block_pattern and (
            self.family in ("ssm", "hybrid"))

    def param_count(self) -> int:
        """Approximate parameter count (dense algebra, for roofline N)."""
        D, hd = self.d_model, self.head_dim_
        attn = D * hd * (self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * hd * D
        mlp = 3 * D * self.d_ff
        if self.n_experts:
            moe = self.n_experts * 3 * D * self.d_ff + D * self.n_experts
            if self.n_shared_experts:
                moe += 3 * D * self.shared_d_ff
            mlp = moe
        per_layer = attn + mlp
        if self.block_pattern:
            # recurrent layers are cheaper; approximate by family
            rec = 4 * D * D
            n_rec = sum(1 for i in range(self.n_layers)
                        if self.block_pattern[i % len(self.block_pattern)]
                        != "attn")
            n_att = self.n_layers - n_rec
            total = n_att * per_layer + n_rec * (rec + mlp if self.d_ff else rec)
        else:
            total = self.n_layers * per_layer
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn + mlp) + \
                self.n_layers * attn  # cross attention
        total += 2 * self.vocab_padded * D  # embed + head
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6·N_active·D)."""
        if not self.n_experts:
            return self.param_count()
        D = self.d_model
        hd = self.head_dim_
        attn = D * hd * (self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * hd * D
        act_mlp = self.n_experts_active * 3 * D * self.d_ff + \
            D * self.n_experts
        if self.n_shared_experts:
            act_mlp += 3 * D * self.shared_d_ff
        return self.n_layers * (attn + act_mlp) + 2 * self.vocab_padded * D


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
