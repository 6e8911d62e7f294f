"""AdamW, the baseline optimizer (port of ``repro/optim/adamw.py``): the
same state as LAMB (``LambState``: fp32 master weights and moments, one
flat buffer per leaf group), a trust ratio of 1, decoupled weight decay on
every leaf, the norms and embeddings included.

The reference has no kernel for it (plain jnp that XLA fuses), so neither
does the port: the step is PyTorch elementwise ops, one group at a time.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.optim.lamb import LambState, lamb_init
from repro_torch.utils import Path


def adamw_init(params: dict, cfg=None) -> LambState:
    """``lamb_init``: the same state, so checkpoints keep the reference's
    layout whichever optimizer wrote them."""
    return lamb_init(params, cfg)


def adamw_update(grads: Dict[Path, torch.Tensor], state: LambState, *,
                 lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, wd: float = 0.01,
                 skip_update: bool = False) -> LambState:
    """One AdamW step over every group: ``w - lr * (mhat / (sqrt(vhat) +
    eps) + wd * w)``.  ``grads``: flat fp32 buffers by group path.  The bias
    corrections ``1 - b ** step`` are float32 powers, as the reference's
    weak-typed ``b1 ** step`` of an int32 step.  ``skip_update`` returns the
    state as it is (master, moments and step untouched, bit for bit);
    otherwise every group's new tensors are made first and swapped in with
    the step together, so an update that raises part-way leaves the state
    as it was (``lamb_update``'s guarantee).  Returns the state."""
    if skip_update:
        return state
    step = state.step + 1
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(b1) ** f32(step))
    bc2 = float(f32(1.0) - f32(b2) ** f32(step))
    new = {}
    for path in state.groups.paths:
        w, g = state.master[path], grads[path]
        m2 = b1 * state.m[path] + (1 - b1) * g
        v2 = b2 * state.v[path] + (1 - b2) * torch.square(g)
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps) + wd * w
        new[path] = (w - lr * upd, m2, v2)
    state.master, state.m, state.v, state.step = (
        {p: w for p, (w, _, _) in new.items()},
        {p: m for p, (_, m, _) in new.items()},
        {p: v for p, (_, _, v) in new.items()}, step)
    return state
