"""Config registry: ``get_config(arch_id)`` + reduced smoke variants
(copy of ``repro/configs/__init__.py`` for the architectures the port
runs: deepseek-7b and rwkv6-1.6b for serving, bert-large and bert-base
for pretraining)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import bert_large, deepseek_7b, rwkv6_1p6b
from repro_torch.configs.base import (DecodeCaps, InputShape, ModelConfig,
                                      TrainConfig)

ARCHS = {c.arch_id: c for c in [deepseek_7b.CONFIG, rwkv6_1p6b.CONFIG,
                                bert_large.CONFIG, bert_large.BERT_BASE]}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs "
                       f"{sorted(ARCHS)}")
    return ARCHS[arch_id]


def smoke_variant(cfg: ModelConfig, *, d_model: int = 256,
                  n_blocks: int = 1, vocab: int = 512) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512.  Same widths
    as the reference's ``smoke_variant`` so parity tests compare like with
    like."""
    d_model = min(d_model, 512)
    pattern = cfg.block_pattern
    n_layers = n_blocks * len(pattern)
    if n_layers > 8:
        n_layers = len(pattern)
    head_dim = 32
    n_heads = max(2, d_model // 64)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads // max(1, cfg.q_per_kv)))
    if n_heads % n_kv:
        n_kv = 1
    upd = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=head_dim, d_ff=d_model * 2,
        vocab_size=vocab,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window
        else 0)
    if cfg.max_position and not cfg.is_encoder_decoder:
        upd.update(max_position=512)   # learned positions (BERT)
    return dataclasses.replace(cfg, **upd)


__all__ = ["ARCHS", "DecodeCaps", "InputShape", "ModelConfig",
           "TrainConfig", "get_config", "smoke_variant"]
