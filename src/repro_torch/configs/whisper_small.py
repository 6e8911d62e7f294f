"""Whisper-small -- encoder-decoder audio transformer, its convolutional
front end a stub (copy of repro/configs/whisper_small.py).

[arXiv:2212.04356] 12L encoder + 12L decoder, d_model=768 12H (kv=12)
d_ff=3072 vocab=51865.  The mel-spectrogram and the convolutional feature
extractor are left out: a request brings its precomputed frame embeddings,
(B, 1500, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,            # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    block_pattern=(("attn", "dense"),),       # decoder self-attn (+cross)
    enc_block_pattern=(("attn_bidir", "dense"),),
    mlp_kind="gelu",
    pos_kind="learned",
    norm_kind="layernorm",
    is_encoder_decoder=True,
    n_enc_layers=12,
    enc_seq=1500,           # 30 s of audio at 50 frames/s (post-conv stub)
    max_position=65536,     # decoder learned positions
    tie_embeddings=True,
    source="Whisper-small enc-dec [arXiv:2212.04356]",
)
