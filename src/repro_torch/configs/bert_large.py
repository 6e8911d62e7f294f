"""BERT-large -- the paper's model (copy of repro/configs/bert_large.py).

[arXiv:1810.04805] 24L d_model=1024 16H d_ff=4096 vocab=30522, learned
positions, GELU, post-LayerNorm.  Phase-1 trains at seq 128, phase-2 at
seq 512 (paper Table 6).
"""
from repro_torch.configs.base import InputShape, ModelConfig

CONFIG = ModelConfig(
    arch_id="bert-large",
    family="encoder",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=30522,
    head_dim=64,
    block_pattern=(("attn_bidir", "dense"),),
    mlp_kind="gelu",
    pos_kind="learned",
    norm_kind="layernorm",
    norm_eps=1e-12,
    is_encoder_only=True,
    max_position=512,
    tie_embeddings=True,   # MLM head reuses token embedding
    source="BERT-large [arXiv:1810.04805], reproduced per Lin et al. 2020",
)

BERT_BASE = ModelConfig(
    arch_id="bert-base",
    family="encoder",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    head_dim=64,
    block_pattern=(("attn_bidir", "dense"),),
    mlp_kind="gelu",
    pos_kind="learned",
    norm_kind="layernorm",
    norm_eps=1e-12,
    is_encoder_only=True,
    max_position=512,
    tie_embeddings=True,
    source="BERT-base [arXiv:1810.04805]",
)

# Paper Table 6: per-GPU sentences/batch, sequence length, MLM predictions.
PHASE1 = InputShape("bert_phase1", 128, 4096, "train")
PHASE2 = InputShape("bert_phase2", 512, 2048, "train")
