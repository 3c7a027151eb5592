"""Config system: architecture + run-shape dataclasses.

One ``ModelConfig`` per assigned architecture lives in configs/<arch>.py with
the exact published hyperparameters; ``reduced()`` derives the CPU-smoke
variant of the same family (fewer/narrower layers, tiny vocab) used by the
per-arch smoke tests.  ``ShapeConfig`` encodes the assigned input-shape set.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention flavour
    attn: str = "gqa"              # gqa | mla | none
    qkv_bias: bool = False
    causal: bool = True
    # MLA (DeepSeek-V2 / MiniCPM3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    # hybrid (Zamba-2): shared attn+MLP block applied every k SSM layers
    shared_attn_every: int = 0
    # modality frontend stub
    frontend: str = "none"         # none | audio | vision
    vis_tokens: int = 256          # VLM: patch embeddings prepended
    # numerics / position
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # beyond-paper perf knobs (§Perf iteration 2): fused projections mean
    # ONE backward dx all-reduce per block path instead of 2-3.
    # fused_gate_up uses a shard-aligned [d, 2, ff] layout (always safe);
    # fused_qkv packs [q|k|v] columns, whose split is only shard-aligned
    # for MHA-shaped configs — default off, enabled per-arch in §Perf.
    fused_qkv: bool = False
    fused_gate_up: bool = True
    # SSD knobs (§Perf iteration on the hybrid/ssm cells): chunk length of
    # the intra-chunk quadratic, and bf16 for the decay/score matrices
    ssm_chunk: int = 128
    ssm_bf16_intra: bool = False

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant: same family/topology, tiny dims."""
        def rd(x, lo, d):
            return max(lo, x // d)

        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=(
                min(max(1, self.num_kv_heads * 4 // self.num_heads), 4)
                if self.num_heads else 0
            ),
            head_dim=32 if self.num_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_head_dim=16 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=16 if self.qk_rope_head_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            num_experts=8 if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            shared_attn_every=2 if self.shared_attn_every else 0,
            vis_tokens=8 if self.frontend == "vision" else self.vis_tokens,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return dataclasses.replace(
            self, seq_len=min(self.seq_len, 64), global_batch=min(self.global_batch, 4)
        )


# The assigned input-shape set (same four for every LM arch).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(config: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The skip rules recorded in DESIGN.md section Arch-applicability."""
    if shape.kind == "decode" and config.is_encoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and config.family not in ("ssm", "hybrid"):
        return False, "long_500k needs sub-quadratic attention (SSM/hybrid only)"
    return True, ""
