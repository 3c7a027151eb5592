"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048, attention-free, d_ff=0, vocab=50280, ssm_state=128.
Mamba-2 defaults: expand=2 (d_inner=4096), headdim=64 (64 SSD heads),
conv width 4, 1 B/C group.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        attn="none",
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv=4,
        ssm_groups=1,
    )
)
