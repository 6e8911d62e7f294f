"""DeepSeek-LLM 7B -- llama-arch dense MHA (copy of repro/configs/deepseek_7b.py).

[arXiv:2401.02954] 30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    head_dim=128,
    block_pattern=(("attn", "dense"),),
    mlp_kind="swiglu",
    pos_kind="rope",
    rope_theta=10000.0,
    norm_kind="rmsnorm",
    tie_embeddings=False,
    source="DeepSeek-LLM 7B llama-arch [arXiv:2401.02954]",
)
