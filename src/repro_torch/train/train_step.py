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
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.amp import LossScaleState, Policy, make_loss_scale
from repro_torch.core.grad_accum import accumulate_gradients
from repro_torch.models import api
from repro_torch.optim import LambState, lamb_init, lamb_update
from repro_torch.optim import warmup_poly_decay
from repro_torch.utils import all_finite, global_norm, tree_map


# the loss-scale leaves of a checkpoint, in the reference's order and dtypes
_LOSS_SCALE_LEAVES = (("scale", np.float32), ("good_steps", np.int32),
                      ("total_skipped", np.int32))


@dataclasses.dataclass
class TrainState:
    """The optimizer state and the loss scale.  The reference's ``err``
    leaf (the compressed exchange's residual) comes with the data-parallel
    slice; like the reference's ``err=None`` it adds no checkpoint leaf."""
    opt: LambState
    loss_scale: LossScaleState

    def _group_leaves(self):
        """(name, (L, *leaf) view) of every optimizer group: master, m, v,
        each in ``LeafGroups.paths`` order."""
        groups = self.opt.groups
        for kind in ("master", "m", "v"):
            stacked = groups.stacked(getattr(self.opt, kind))
            for path in groups.paths:
                yield f"opt/{kind}/" + "/".join(path), stacked[path]

    def checkpoint_leaves(self) -> List[Tuple[str, np.ndarray]]:
        """The state as the reference's checkpoint holds it: (name, numpy
        array) in its leaf order -- ``opt/step`` (int32), master, m and v
        (float32, a block leaf stacked over the layers), then the loss
        scale (float32, int32, int32).  On the CPU the group arrays share
        memory with the state."""
        out = [("opt/step", np.asarray(self.opt.step, np.int32))]
        out += [(name, t.detach().cpu().numpy())
                for name, t in self._group_leaves()]
        out += [(f"loss_scale/{k}", np.asarray(getattr(self.loss_scale, k),
                                               dtype))
                for k, dtype in _LOSS_SCALE_LEAVES]
        return out

    def load_checkpoint_leaves(self, leaves) -> None:
        """Load (name, numpy array) pairs as ``checkpoint_leaves`` gives
        them, in place: each group buffer is copied into where it lies (the
        tensors stay on their device).  Names, shapes and dtypes are all
        checked before anything is written; a mismatch raises
        ``ValueError``."""
        leaves = list(leaves)
        views = list(self._group_leaves())
        want = ([("opt/step", (), np.int32)]
                + [(n, tuple(t.shape), np.float32) for n, t in views]
                + [(f"loss_scale/{k}", (), dtype)
                   for k, dtype in _LOSS_SCALE_LEAVES])
        if [n for n, _ in leaves] != [n for n, _, _ in want]:
            raise ValueError(
                f"checkpoint leaves {[n for n, _ in leaves][:4]}... (of "
                f"{len(leaves)}) are not this state's "
                f"{[n for n, _, _ in want][:4]}... (of {len(want)})")
        for (name, a), (_, shape, dtype) in zip(leaves, want):
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(f"leaf {name}: {a.dtype} {a.shape}, "
                                 f"expected {np.dtype(dtype)} {shape}")
        arrays = [a for _, a in leaves]
        for (_, view), a in zip(views, arrays[1:]):
            view.copy_(torch.from_numpy(a))
        self.opt.step = int(arrays[0])
        self.loss_scale = LossScaleState(float(arrays[-3]), int(arrays[-2]),
                                         int(arrays[-1]))


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
    integer tensors on the card).  Updates ``state`` in place, all at once
    after the last operation that can fail, and returns (state, metrics):
    loss, grad_norm, lr, loss_scale, skipped and the loss function's
    metrics.  ``impl`` is passed to the kernels (``kernels/ops.py``)."""
    tcfg.check_supported()
    loss, grads, metrics = step_gradients(state, batch, cfg=cfg, tcfg=tcfg,
                                          policy=policy, impl=impl)
    finite = bool(all_finite(grads))
    new_ls, _ = make_loss_scale(policy).update(state.loss_scale, finite)
    grads, gnorm = _clip_grads(grads, tcfg.grad_clip)
    # the optimizer swaps its new tensors and step in at its end, and the
    # loss scale follows: a step that raises leaves the state as it was
    state.opt, lr = _optimizer_update(grads, state.opt, tcfg,
                                      skip_update=not finite, impl=impl)
    state.loss_scale = new_ls
    out = {"loss": loss.float(), "grad_norm": gnorm, "lr": lr,
           "loss_scale": new_ls.scale, "skipped": not finite}
    out.update(metrics)
    return state, out
