"""Model API facade for training (port of the encoder-only part of
``repro/models/api.py``): the loss function, parameter init, the train
batch schema and synthetic batches.

The reference's ``ShapeDtypeStruct`` schema becomes ``BatchField`` (shape
and numpy dtype); synthetic batches are drawn with numpy from a seed and
moved to the device by ``to_device``.  Decoder losses and the serving and
sharding structs belong to later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.models import bert as BERT


@dataclasses.dataclass(frozen=True)
class BatchField:
    shape: Tuple[int, ...]
    dtype: type = np.int32


def mlm_positions_count(seq_len: int) -> int:
    """Paper Table 6: 20 predictions at S=128, 80 at S=512 (~15%)."""
    return max(1, int(round(seq_len * 0.15)) + (0 if seq_len % 8 else 0))


def _encoder_only(cfg: ModelConfig) -> None:
    if not cfg.is_encoder_only:
        raise NotImplementedError("the port trains encoder-only models "
                                  "(BERT); decoder training ports later")


def make_loss_fn(cfg: ModelConfig, policy: Policy, *, remat: bool = False,
                 impl=None):
    """``loss_fn(params, batch) -> (loss, metrics)``."""
    _encoder_only(cfg)

    def loss_fn(params, batch):
        return BERT.bert_pretrain_loss(params, batch, cfg, policy,
                                       remat=remat, impl=impl)
    return loss_fn


def init_params(cfg: ModelConfig, *, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    _encoder_only(cfg)
    return BERT.init_bert(cfg, seed=seed, dtype=dtype, device=device)


def train_batch_struct(cfg: ModelConfig, shape: InputShape
                       ) -> Dict[str, BatchField]:
    _encoder_only(cfg)
    b, s = shape.global_batch, shape.seq_len
    p = mlm_positions_count(s)
    return {"tokens": BatchField((b, s)), "type_ids": BatchField((b, s)),
            "mlm_positions": BatchField((b, p)),
            "mlm_labels": BatchField((b, p)), "nsp_labels": BatchField((b,))}


def make_synth_batch(seed: int, cfg: ModelConfig, shape: InputShape
                     ) -> Dict[str, np.ndarray]:
    """A random batch with the schema's statistics, as the reference's:
    positions 0 .. P-1, type ids 0, random tokens, labels and NSP labels.
    Drawn with numpy (the values differ from ``jax.random``'s)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, f in sorted(train_batch_struct(cfg, shape).items()):
        if name == "nsp_labels":
            out[name] = rng.integers(0, 2, f.shape)
        elif name == "mlm_positions":
            out[name] = np.broadcast_to(np.arange(f.shape[-1]), f.shape)
        elif name == "type_ids":
            out[name] = np.zeros(f.shape)
        else:
            out[name] = rng.integers(0, cfg.vocab_size, f.shape)
        out[name] = np.ascontiguousarray(out[name], dtype=f.dtype)
    return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> int64 tensors on ``device`` (indices for gathers)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device=device,
                                                  dtype=torch.int64)
            for k, v in batch.items()}
