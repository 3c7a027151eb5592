"""zamba2-2.7b [hybrid] — Mamba-2 backbone + shared attention block
[arXiv:2411.15242; hf].

54 Mamba-2 layers, d_model=2560, ssm_state=64, with a parameter-shared
attention+MLP block (32 MHA heads, d_ff=10240) applied every 6 layers.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10_240,
        vocab_size=32_000,
        attn="gqa",
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        shared_attn_every=6,
    )
)
