"""Training step on one card (port of the single-device path of
``repro/train/train_step.py``): the paper's optimization stack composed.

    loss -> [dynamic loss scale] -> grad over [accum_steps micro-batches]
         -> unscale -> finite check -> clip -> LAMB with fp32 master weights

The reference's ``grad_reduce`` / ``grad_exchange`` / ``overlap_reduce``
hooks (the data-parallel exchange) come with a later slice;
``TrainConfig.check_supported`` refuses their settings.

Host and device.  PyTorch runs eagerly, so the step reads two host values
from the card each step: the finite flag (one sync, which decides the
skip and the loss-scale update on the host) and nothing else until the
caller reads the metrics.  A skipped step launches no optimizer kernel, so
master weights, moments and step count stay bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.amp import LossScaleState, Policy, make_loss_scale
from repro_torch.core.grad_accum import accumulate_gradients
from repro_torch.models import api
from repro_torch.optim import LambState, lamb_init, lamb_update
from repro_torch.optim import warmup_poly_decay
from repro_torch.utils import all_finite, global_norm, tree_map


@dataclasses.dataclass
class TrainState:
    opt: LambState
    loss_scale: LossScaleState


def init_train_state(params: dict, policy: Policy,
                     tcfg: TrainConfig) -> TrainState:
    """fp32 master weights and zero moments from a parameter tree (any
    dtype; copied), and the policy's initial loss scale."""
    tcfg.check_supported()
    return TrainState(lamb_init(params), make_loss_scale(policy).init())


def _optimizer_update(grads, opt: LambState, tcfg: TrainConfig, *,
                      skip_update: bool, impl=None):
    lr = warmup_poly_decay(opt.step + 1, base_lr=tcfg.learning_rate,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
    return lamb_update(grads, opt, lr=lr, wd=tcfg.weight_decay,
                       skip_update=skip_update, impl=impl), lr


def _clip_grads(grads: dict, max_norm: float):
    """Scale every gradient by min(1, max_norm / ||g||), in place; returns
    (grads, the global norm before clipping)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, gnorm


def step_gradients(state: TrainState, batch, *, cfg: ModelConfig,
                   tcfg: TrainConfig, policy: Policy,
                   impl: Optional[str] = None):
    """The gradient part of a step: the compute copy of the master weights,
    the scaled loss over the micro-batches, unscaled fp32 gradients.
    Returns (loss (0-d fp32, unscaled), {group path: flat fp32 grad},
    metrics of the last micro-batch)."""
    opt = state.opt
    loss_scale = make_loss_scale(policy)
    loss_fn = api.make_loss_fn(cfg, policy, remat=tcfg.remat, impl=impl)
    # the compute copy, one leaf per layer tensor; in f32 the leaves share
    # the master's storage (nothing writes the master before the update)
    compute = policy.cast_params(opt.master)
    params = tree_map(lambda t: t.detach().requires_grad_(),
                      opt.groups.tree(compute))

    def scaled_loss(p, b):
        loss, metrics = loss_fn(p, b)
        return loss_scale.scale_loss(loss, state.loss_scale), metrics

    loss, grads, metrics = accumulate_gradients(
        scaled_loss, params, opt.groups, batch, tcfg.accum_steps)
    grads = loss_scale.unscale_grads(grads, state.loss_scale)
    return loss / state.loss_scale.scale, grads, metrics


def train_step_fn(state: TrainState, batch, *, cfg: ModelConfig,
                  tcfg: TrainConfig, policy: Policy,
                  impl: Optional[str] = None):
    """One optimizer step on ``batch`` (a dict of (global batch, ...)
    integer tensors on the card).  Updates ``state`` in place and returns
    (state, metrics): loss, grad_norm, lr, loss_scale, skipped and the
    loss function's metrics.  ``impl`` is passed to the kernels
    (``kernels/ops.py``)."""
    tcfg.check_supported()
    loss, grads, metrics = step_gradients(state, batch, cfg=cfg, tcfg=tcfg,
                                          policy=policy, impl=impl)
    finite = bool(all_finite(grads))
    new_ls, _ = make_loss_scale(policy).update(state.loss_scale, finite)
    grads, gnorm = _clip_grads(grads, tcfg.grad_clip)
    state.opt, lr = _optimizer_update(grads, state.opt, tcfg,
                                      skip_update=not finite, impl=impl)
    state.loss_scale = new_ls
    out = {"loss": loss.float(), "grad_norm": gnorm, "lr": lr,
           "loss_scale": new_ls.scale, "skipped": not finite}
    out.update(metrics)
    return state, out
