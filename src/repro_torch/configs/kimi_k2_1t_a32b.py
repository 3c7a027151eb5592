"""kimi-k2-1t-a32b [moe] — Kimi K2, trillion-param MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8, head_dim=112) d_ff=2048 per expert,
vocab=163840, MoE 384 experts top-8 (+1 shared, per the K2 report).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=112,
        d_ff=0,
        vocab_size=163_840,
        attn="gqa",
        num_experts=384,
        experts_per_token=8,
        num_shared_experts=1,
        moe_d_ff=2048,
    )
)
