"""Qwen3-MoE 30B-A3B -- 128 experts, top-8, GQA kv=4, qk-norm (copy of
repro/configs/qwen3_moe_30b_a3b.py).

[hf:Qwen/Qwen3-30B-A3B] 48L d_model=2048 32H (kv=4) expert d_ff=768
vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,            # per-expert FFN width
    vocab_size=151936,
    head_dim=128,        # qwen3 uses explicit head_dim=128 (> d/H)
    block_pattern=(("attn", "moe"),),
    mlp_kind="swiglu",
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    pos_kind="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    norm_kind="rmsnorm",
    tie_embeddings=False,
    source="Qwen3-30B-A3B 128e top-8 [hf:Qwen/Qwen3-30B-A3B]",
)
