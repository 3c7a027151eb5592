"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-110B].

80L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=49152 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=49_152,
        vocab_size=152_064,
        attn="gqa",
        qkv_bias=True,
    )
)
