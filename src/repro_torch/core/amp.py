"""Mixed-precision policy (port of ``Policy``/``make_policy`` in
``repro/core/amp.py``).

``param_dtype`` is the storage dtype of the compute copy of the weights.
The port stores that copy once, in ``param_dtype``: the JAX path keeps f32
weights and casts them at every use, which gives the same bits, but on the
card the per-step cast would move 14 GB of f32 weights for a 7B model.
Loss scaling belongs to the training slice and is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.bfloat16    # compute-copy storage
    compute_dtype: torch.dtype = torch.bfloat16  # matmul inputs
    reduce_dtype: torch.dtype = torch.float32    # softmax / norm / loss
    output_dtype: torch.dtype = torch.float32


def make_policy(name: str) -> Policy:
    """'f32' | 'bf16' | 'f16'."""
    if name in ("f32", "fp32", "float32"):
        return Policy(torch.float32, torch.float32, torch.float32,
                      torch.float32)
    if name in ("bf16", "bfloat16"):
        return Policy(torch.bfloat16, torch.bfloat16, torch.float32,
                      torch.float32)
    if name in ("f16", "fp16", "float16"):
        return Policy(torch.float16, torch.float16, torch.float32,
                      torch.float32)
    raise ValueError(f"unknown precision policy {name!r}")
