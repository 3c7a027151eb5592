"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-8b-base].

40L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=12800 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12_800,
        vocab_size=49_155,
        attn="gqa",
    )
)
