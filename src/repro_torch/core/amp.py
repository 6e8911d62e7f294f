"""Mixed precision (port of ``repro/core/amp.py``): the dtype policy and
the APEX-style dynamic loss scale of the paper's §4.2.

``param_dtype`` is the storage dtype of the compute copy of the weights.
For serving the port stores that copy once, in ``param_dtype``: the JAX
path keeps f32 weights and casts them at every use, which gives the same
bits, but on the card the per-step cast would move 14 GB of f32 weights for
a 7B model.  For training the fp32 master weights live in the optimizer
state and ``Policy.cast_params`` makes the compute copy once per step, as
in the reference.

The loss-scale state is three host numbers (scale, consecutive good steps,
skipped steps), updated from one host flag per step.  The constants are
the reference's (``torch.amp.GradScaler`` starts at 2**16 and is not
used).  All arithmetic on the scale is exact (powers of two inside
[1, 2**24]), so host floats give the reference's float32 values.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.utils import tree_cast, tree_map


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.bfloat16    # compute-copy storage
    compute_dtype: torch.dtype = torch.bfloat16  # matmul inputs
    reduce_dtype: torch.dtype = torch.float32    # softmax / norm / loss
    output_dtype: torch.dtype = torch.float32

    def cast_params(self, params):
        """The compute copy of a tree of master weights.  Leaves already in
        ``param_dtype`` (f32 policy) are the master tensors themselves."""
        return tree_cast(params, self.param_dtype)

    @property
    def needs_loss_scaling(self) -> bool:
        return self.compute_dtype == torch.float16


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


class LossScaleState(NamedTuple):
    scale: float          # current loss scale (a float32 value)
    good_steps: int       # consecutive finite steps
    total_skipped: int    # updates skipped so far


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    """APEX-style dynamic loss scaling (paper §2.3 / §4.2): multiply the
    loss by ``scale``; on a non-finite gradient skip the update and halve
    the scale, else double it after ``growth_interval`` good steps."""
    initial_scale: float = 2.0 ** 15
    growth_interval: int = 2000
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    def init(self) -> LossScaleState:
        return LossScaleState(float(self.initial_scale), 0, 0)

    def scale_loss(self, loss: torch.Tensor,
                   state: LossScaleState) -> torch.Tensor:
        return loss * state.scale

    def unscale_grads(self, grads, state: LossScaleState):
        inv = float(np.float32(1.0) / np.float32(state.scale))
        return tree_map(lambda g: g.float() * inv, grads)

    def update(self, state: LossScaleState, grads_finite: bool
               ) -> Tuple[LossScaleState, bool]:
        """Returns (new_state, should_apply_update)."""
        if grads_finite:
            grew = state.good_steps + 1 >= self.growth_interval
            scale = (min(state.scale * self.growth_factor, self.max_scale)
                     if grew else state.scale)
            return LossScaleState(scale, 0 if grew else state.good_steps + 1,
                                  state.total_skipped), True
        scale = max(state.scale * self.backoff_factor, self.min_scale)
        return LossScaleState(scale, 0, state.total_skipped + 1), False


class NoOpLossScale:
    """Loss scale for bf16/f32 policies: scale 1, updates never skipped."""

    def init(self) -> LossScaleState:
        return LossScaleState(1.0, 0, 0)

    def scale_loss(self, loss, state):
        return loss

    def unscale_grads(self, grads, state):
        return tree_map(lambda g: g.float(), grads)

    def update(self, state, grads_finite):
        return state, True


def make_loss_scale(policy: Policy, **kw):
    if policy.needs_loss_scaling:
        return DynamicLossScale(**kw)
    return NoOpLossScale()


def loss_scale_summary(state: LossScaleState) -> dict:
    """JSON-serializable snapshot of the dynamic loss-scale state (copy of
    ``repro/core/amp.py`` ``loss_scale_summary``).

    Recorded in the checkpoint manifest (``train/checkpoint.py``) so a
    resumed run's AMP trajectory is auditable without loading the npz; the
    state itself is saved with the ``TrainState`` and restores exactly.
    The port's state is host numbers, so nothing is read from the card.
    """
    return {"scale": float(np.float32(state.scale)),
            "good_steps": int(state.good_steps),
            "total_skipped": int(state.total_skipped)}
