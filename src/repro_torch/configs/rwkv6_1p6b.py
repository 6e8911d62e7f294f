"""RWKV-6 "Finch" 1.6B -- attention-free, data-dependent decay (copy of
repro/configs/rwkv6_1p6b.py).

[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536, head_size 64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # d_model / rwkv_head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    block_pattern=(("rwkv", "rwkv_cm"),),
    mlp_kind="gelu",     # unused; channel-mix is relu^2
    pos_kind="none",
    norm_kind="layernorm",
    rwkv_head_size=64,
    tie_embeddings=False,
    source="Finch: RWKV-6 data-dependent decay [arXiv:2404.05892]",
)
