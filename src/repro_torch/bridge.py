"""Weights from the JAX package's parameter layout into the port's, and back.

The port keeps ``params["blocks"]`` as a list of per-layer dicts.  The
reference has two layouts:

* decoders (``transformer.init_model``): a tuple, one entry per
  ``block_pattern`` position, of dicts whose leaves carry a leading
  ``n_blocks`` axis (``jax.vmap(init_one)``).  Layer ``i`` of the port is
  block ``i // len(pattern)`` at position ``i % len(pattern)``, the order in
  which the reference's scan runs them.  An encoder-decoder's
  ``enc_blocks`` are laid out the same way over ``enc_block_pattern``
  (whisper: one position, ``n_enc_layers`` stacked), and its ``enc_norm``,
  ``enc_pos`` and each decoder layer's ``norm_cross`` and ``cross`` are
  carried as any other leaf.
* BERT (``bert.init_bert``): one dict whose leaves carry a leading
  ``n_layers`` axis.

Leaf layouts are kept as they are (``wq`` (d, H, Dh), ``wo`` (H, Dh, d),
the query/key norms ``q_norm`` and ``k_norm`` (Dh,), an MoE layer's
``router`` (d, E), ``wi`` and ``wg`` (E, d, f) and ``wo`` (E, f, d), a mamba
mixer's ``in_proj`` (d, 2 d_inner), ``conv_w`` (d_conv, d_inner),
``x_proj`` (d_inner, dt_rank + 2 N), ``dt_proj`` (dt_rank, d_inner),
``a_log`` (d_inner, N), ``out_proj`` (d_inner, d) and its vectors ...), so
the conversion is lossless; jamba's 8-position pattern unstacks as any
other, and qwen2-vl's tree (QKV biases ``bq`` (H, Dh), ``bk`` and ``bv``
(KV, Dh), an untied ``lm_head`` (d, V); its vision tower is a stub with
no weights) as any decoder's.  Callers pass numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device=device,
                                                          dtype=dtype)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32).numpy()


def params_from_jax(np_params: dict, cfg: ModelConfig, device="cuda",
                    dtype=torch.float32) -> dict:
    """JAX parameter pytree (numpy leaves) -> the port's parameter dict.
    Takes both layouts of ``params["blocks"]`` (see the module
    docstring)."""
    stacked = np_params["blocks"]
    if isinstance(stacked, dict):   # BERT: one dict stacked over layers
        layers = [_index(stacked, i) for i in range(cfg.n_layers)]
    else:
        layers = _unstack(stacked, cfg.block_pattern, cfg.n_layers)
    lists = {"blocks": layers}
    if cfg.is_encoder_decoder:
        lists["enc_blocks"] = _unstack(np_params["enc_blocks"],
                                       cfg.enc_block_pattern,
                                       cfg.n_enc_layers)
    out = {k: _to_torch(v, device, dtype) for k, v in np_params.items()
           if k not in lists}
    for k, one in lists.items():
        out[k] = [_to_torch(layer, device, dtype) for layer in one]
    return out


def _unstack(stacked, pattern, n_layers):
    """The per-layer dicts of one tuple of stacked dicts, one per position
    of ``pattern``: layer i is block i // P at position i % P."""
    npos = len(pattern)
    if len(stacked) != npos:
        raise ValueError(f"{len(stacked)} stacked block groups for a "
                         f"{npos}-position block pattern")
    return [_index(stacked[pi], bi) for bi in range(n_layers // npos)
            for pi in range(npos)]


def params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The inverse of ``params_from_jax``: float32 numpy leaves with the
    blocks restacked as the JAX package lays them out (one stacked dict for
    an encoder-only model, else one per pattern position; an
    encoder-decoder's ``enc_blocks`` one per encoder pattern position)."""
    lists = {"blocks": cfg.block_pattern}
    if cfg.is_encoder_decoder:
        lists["enc_blocks"] = cfg.enc_block_pattern
    out = {k: _to_numpy(v) for k, v in params.items() if k not in lists}
    for key, pattern in lists.items():
        layers = [_to_numpy(p) for p in params[key]]
        if cfg.is_encoder_only:
            out[key] = _stack(layers)
            continue
        npos = len(pattern)
        out[key] = tuple(
            _stack([layers[bi * npos + pi]
                    for bi in range(len(layers) // npos)])
            for pi in range(npos))
    return out


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
