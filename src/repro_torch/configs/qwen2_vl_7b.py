"""Qwen2-VL 7B -- vision-language decoder with M-RoPE, its vision tower a
stub (copy of repro/configs/qwen2_vl_7b.py).

[arXiv:2409.12191] 28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064.
M-RoPE: rotary sections (16, 24, 24) over (temporal, height, width)
position triples.  The ViT and its projector are left out: a request or a
batch brings precomputed patch embeddings (B, 256, d_model), which
overwrite the first 256 positions of the sequence, and may bring (3, B, S)
position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    block_pattern=(("attn", "dense"),),
    mlp_kind="swiglu",
    pos_kind="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    norm_kind="rmsnorm",
    n_vision_tokens=256,
    tie_embeddings=False,
    source="Qwen2-VL-7B M-RoPE, dynamic resolution [arXiv:2409.12191]",
)
