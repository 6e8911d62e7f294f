"""Granite-MoE 3B-A800M -- 40 experts, top-8, GQA kv=8 (copy of
repro/configs/granite_moe_3b_a800m.py).

[hf:ibm-granite/granite-3.0-1b-a400m-base family, scaled per assignment]
32L d_model=1536 24H (kv=8) expert d_ff=512 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,            # per-expert FFN width
    vocab_size=49155,
    head_dim=64,
    block_pattern=(("attn", "moe"),),
    mlp_kind="swiglu",
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    pos_kind="rope",
    rope_theta=10000.0,
    norm_kind="rmsnorm",
    tie_embeddings=True,
    source="Granite-3.0 MoE [hf:ibm-granite/granite-3.0-1b-a400m-base]",
)
