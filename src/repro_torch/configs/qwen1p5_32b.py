"""Qwen1.5-32B -- dense MHA with QKV bias (copy of
repro/configs/qwen1p5_32b.py).

[hf:Qwen/Qwen1.5 family] 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    head_dim=128,
    block_pattern=(("attn", "dense"),),
    mlp_kind="swiglu",
    pos_kind="rope",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    norm_kind="rmsnorm",
    tie_embeddings=False,
    source="Qwen1.5 QKV-bias dense [hf:Qwen/Qwen1.5-0.5B scaled to 32B]",
)
