"""Gemma2-27B -- dense, alternating local(SWA-4096)/global attention,
softcaps (copy of repro/configs/gemma2_27b.py).

[arXiv:2408.00118] 46L d_model=4608 32H (kv=16) d_ff=36864 vocab=256000.
Pre+post block RMSNorm, attn logit softcap 50, final logit softcap 30,
geglu MLP, embeddings scaled by sqrt(d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    block_pattern=(("attn_local", "dense"), ("attn_global", "dense")),
    mlp_kind="geglu",
    pos_kind="rope",
    rope_theta=10000.0,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    norm_kind="rmsnorm",
    post_block_norm=True,
    scale_embeddings=True,
    tie_embeddings=True,
    source="Gemma2-27B local+global alternating, logit softcap [arXiv:2408.00118]",
)
