"""Weights from the JAX package's parameter layout into the port's, and back.

The port keeps ``params["blocks"]`` as a list of per-layer dicts.  The
reference has two layouts:

* decoders (``transformer.init_model``): a tuple, one entry per
  ``block_pattern`` position, of dicts whose leaves carry a leading
  ``n_blocks`` axis (``jax.vmap(init_one)``).  Layer ``i`` of the port is
  block ``i // len(pattern)`` at position ``i % len(pattern)``, the order in
  which the reference's scan runs them.
* BERT (``bert.init_bert``): one dict whose leaves carry a leading
  ``n_layers`` axis.

Leaf layouts are kept as they are (``wq`` (d, H, Dh), ``wo`` (H, Dh, d),
...), so the conversion is lossless.  Callers pass numpy arrays
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
    pattern = cfg.block_pattern
    stacked = np_params["blocks"]
    if isinstance(stacked, dict):   # BERT: one dict stacked over layers
        layers = [_index(stacked, i) for i in range(cfg.n_layers)]
    elif len(stacked) != len(pattern):
        raise ValueError(f"{len(stacked)} stacked block groups for a "
                         f"{len(pattern)}-position block_pattern")
    else:
        layers = [_index(stacked[pi], bi) for bi in range(cfg.n_blocks)
                  for pi in range(len(pattern))]
    out = {k: _to_torch(v, device, dtype) for k, v in np_params.items()
           if k != "blocks"}
    out["blocks"] = [_to_torch(one, device, dtype) for one in layers]
    return out


def params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The inverse of ``params_from_jax``: float32 numpy leaves with the
    blocks restacked as the JAX package lays them out (one stacked dict for
    an encoder-only model, else one per pattern position)."""
    npos = len(cfg.block_pattern)
    layers = [_to_numpy(p) for p in params["blocks"]]
    if cfg.is_encoder_only:
        stacked = _stack(layers)
    else:
        stacked = tuple(
            _stack([layers[bi * npos + pi] for bi in range(cfg.n_blocks)])
            for pi in range(npos))
    out = {k: _to_numpy(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = stacked
    return out


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
