"""internvl2-76b [vlm] — InternViT + LLM backbone [arXiv:2404.16821].

The assigned config specifies the 80L d_model=8192 64H (GQA kv=8,
head_dim=128) d_ff=28672 vocab=128256 transformer BACKBONE (Llama-3-70B
shaped); the InternViT frontend is a STUB: input_specs() provides
precomputed patch embeddings [B, vis_tokens, d_model] prepended to the
token sequence.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="internvl2-76b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28_672,
        vocab_size=128_256,
        attn="gqa",
        frontend="vision",
        vis_tokens=256,
        rope_theta=500_000.0,
    )
)
