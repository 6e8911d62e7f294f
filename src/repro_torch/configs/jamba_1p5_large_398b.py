"""Jamba-1.5-Large 398B -- hybrid Mamba + attention 1:7 interleave, MoE
16 experts top-2 (copy of repro/configs/jamba_1p5_large_398b.py).

[arXiv:2403.19887] 72L d_model=8192 64H (kv=8) d_ff=24576 vocab=65536.
Block of 8 layers: 1 attention + 7 mamba; MoE FFN on every other layer.
"""
from repro_torch.configs.base import ModelConfig

_BLOCK = tuple(
    ("attn" if i == 0 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    block_pattern=_BLOCK,
    mlp_kind="swiglu",
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    pos_kind="none",        # no positional encoding: mamba provides order
    norm_kind="rmsnorm",
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    tie_embeddings=False,
    source="Jamba-1.5-Large Mamba+attn 1:7, MoE 16e top-2 [arXiv:2403.19887]",
)
