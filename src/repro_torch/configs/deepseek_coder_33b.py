"""DeepSeek-Coder 33B -- llama-arch dense, GQA kv=8 (copy of
repro/configs/deepseek_coder_33b.py).

[arXiv:2401.14196] 62L d_model=7168 56H (kv=8) d_ff=19200 vocab=32256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    head_dim=128,
    block_pattern=(("attn", "dense"),),
    mlp_kind="swiglu",
    pos_kind="rope",
    rope_theta=100000.0,
    norm_kind="rmsnorm",
    tie_embeddings=False,
    source="DeepSeek-Coder 33B llama-arch [arXiv:2401.14196]",
)
