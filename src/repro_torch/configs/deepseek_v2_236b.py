"""deepseek-v2-236b [moe] — MLA + fine-grained MoE [arXiv:2405.04434; hf].

60L d_model=5120 128H, MLA kv_lora_rank=512 (q_lora 1536, qk_nope 128,
qk_rope 64, v_head 128), d_ff=1536 per routed expert, vocab=102400,
MoE 2 shared + 160 routed top-6.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=0,
        vocab_size=102_400,
        attn="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        num_experts=160,
        experts_per_token=6,
        num_shared_experts=2,
        moe_d_ff=1536,
    )
)
