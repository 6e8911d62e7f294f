"""Config registry: ``get_config(arch_id)`` + reduced smoke variants
(copy of ``repro/configs/__init__.py`` for the architectures the port
runs: deepseek-7b, rwkv6-1.6b, the dense decoder variants gemma2-27b,
qwen1.5-32b and deepseek-coder-33b, the MoE decoders
granite-moe-3b-a800m and qwen3-moe-30b-a3b, the hybrid
jamba-1.5-large-398b, the encoder-decoder whisper-small, the
vision-language qwen2-vl-7b (M-RoPE, a vision stub), and bert-large and
bert-base for pretraining; ``ASSIGNED`` is the reference's list of the
ten model families)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (bert_large, deepseek_7b,
                                 deepseek_coder_33b, gemma2_27b,
                                 granite_moe_3b_a800m,
                                 jamba_1p5_large_398b, qwen1p5_32b,
                                 qwen2_vl_7b, qwen3_moe_30b_a3b,
                                 rwkv6_1p6b, whisper_small)
from repro_torch.configs.base import (DecodeCaps, InputShape, ModelConfig,
                                      TrainConfig)

ARCHS = {c.arch_id: c for c in [deepseek_7b.CONFIG, rwkv6_1p6b.CONFIG,
                                gemma2_27b.CONFIG, qwen1p5_32b.CONFIG,
                                deepseek_coder_33b.CONFIG,
                                granite_moe_3b_a800m.CONFIG,
                                qwen3_moe_30b_a3b.CONFIG,
                                jamba_1p5_large_398b.CONFIG,
                                whisper_small.CONFIG, qwen2_vl_7b.CONFIG,
                                bert_large.CONFIG, bert_large.BERT_BASE]}

ASSIGNED = [
    "rwkv6-1.6b", "qwen3-moe-30b-a3b", "granite-moe-3b-a800m", "qwen1.5-32b",
    "deepseek-coder-33b", "whisper-small", "jamba-1.5-large-398b",
    "deepseek-7b", "gemma2-27b", "qwen2-vl-7b",
]


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs "
                       f"{sorted(ARCHS)}")
    return ARCHS[arch_id]


def smoke_variant(cfg: ModelConfig, *, d_model: int = 256,
                  n_blocks: int = 1, vocab: int = 512) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts
    (top-2).  Same widths as the reference's ``smoke_variant`` so parity
    tests compare like with like."""
    d_model = min(d_model, 512)
    pattern = cfg.block_pattern
    n_layers = n_blocks * len(pattern)
    if n_layers > 8:  # jamba's 8-layer pattern: keep one block
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
    if cfg.n_experts:
        upd.update(n_experts=4, top_k=2, moe_d_ff=d_model * 2)
    if cfg.mrope_sections:
        # the sections sum to head_dim // 2
        upd.update(mrope_sections=(head_dim // 2 - 8, 4, 4))
    if cfg.is_encoder_decoder:
        upd.update(n_enc_layers=2, enc_seq=16, max_position=4096)
    if cfg.max_position and not cfg.is_encoder_decoder:
        upd.update(max_position=512)   # learned positions (BERT)
    if cfg.n_vision_tokens:
        upd.update(n_vision_tokens=8)
    return dataclasses.replace(cfg, **upd)


def cut_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """The config's first ``n_layers`` layers at its widths: a prefix of
    the block pattern when that is shorter than one block (jamba's first 4
    of its 8-layer block: (attn, dense), (mamba, moe), (mamba, dense),
    (mamba, moe)), else whole blocks: past one block, a depth that is not
    a multiple of it raises ``ValueError`` (``ModelConfig`` refuses an
    ``n_layers`` that does not tile its block pattern).  An
    encoder-decoder's encoder is cut to the same depth (whisper-small at 2:
    2 encoder and 2 decoder layers)."""
    if cfg.is_encoder_decoder:
        cfg = dataclasses.replace(cfg, n_enc_layers=n_layers)
    if n_layers < len(cfg.block_pattern):
        return dataclasses.replace(cfg, n_layers=n_layers,
                                   block_pattern=cfg.block_pattern[:n_layers])
    return dataclasses.replace(cfg, n_layers=n_layers)


def cut_positions(cfg: ModelConfig, positions) -> ModelConfig:
    """One block of the given positions of the config's block pattern, in
    order, at its widths: jamba's ``(2,)`` is its (mamba, dense) layer
    alone.  A depth cut the reference lacks, as ``cut_depth``'s; a
    position out of the pattern, repeated or out of order raises
    ``ValueError``."""
    positions = tuple(positions)
    n = len(cfg.block_pattern)
    if not positions or list(positions) != sorted(set(positions)) or \
            not all(0 <= p < n for p in positions):
        raise ValueError(f"positions {positions}: distinct, increasing "
                         f"positions of the {n}-position block pattern")
    return dataclasses.replace(
        cfg, n_layers=len(positions),
        block_pattern=tuple(cfg.block_pattern[p] for p in positions))


__all__ = ["ARCHS", "ASSIGNED", "DecodeCaps", "InputShape", "ModelConfig",
           "TrainConfig", "cut_depth", "cut_positions", "get_config",
           "smoke_variant"]
