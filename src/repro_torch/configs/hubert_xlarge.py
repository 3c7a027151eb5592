"""hubert-xlarge [audio] — encoder-only [arXiv:2106.07447].

48L d_model=1280 16H (MHA kv=16, head_dim=80) d_ff=5120 vocab=504
(masked-prediction cluster targets).  The conv waveform frontend is a STUB:
input_specs() provides precomputed frame embeddings [B, S, d_model].
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        attn="gqa",
        causal=False,
        frontend="audio",
    )
)
