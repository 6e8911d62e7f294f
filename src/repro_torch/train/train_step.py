"""Training step (port of ``repro/train/train_step.py``): the paper's
optimization stack composed.

    loss -> [dynamic loss scale] -> grad over [accum_steps micro-batches]
         -> [gradient collective: psum | ring | hierarchical | bucketed]
         -> unscale -> finite check -> clip -> LAMB with fp32 master weights

``train_step_fn`` is the step on one card.  ``make_train_step_dp`` is the
reference's pure data parallelism (``shard_map`` over the data axes, the
model replicated, the exchange explicit), with each device a rank of
``torch.distributed`` (``launch/mesh.py``): each rank takes its
contiguous rows of the global batch and the step's ``grad_reduce`` and
``metric_reduce`` hooks run the exchange (``core/collectives.py``).  The
reference's ``grad_exchange`` (compressed) and ``overlap_reduce``
(overlapped drain) hooks come with later slices;
``TrainConfig.check_supported`` refuses their settings.

Host and device.  PyTorch runs eagerly, so the step reads two host values
from the card each step: the finite flag (one sync, which decides the
skip and the loss-scale update on the host) and nothing else until the
caller reads the metrics.  A skipped step launches no optimizer kernel, so
master weights, moments and step count stay bit-identical.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import collectives as C
from repro_torch.core.amp import (LossScaleState, Policy, make_loss_scale,
                                  make_policy)
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
    """The optimizer state and the loss scale, replicated on every rank of
    a data-parallel run.  The reference's ``err`` leaf (the compressed
    exchange's residual) comes with the compressed exchange; like the
    reference's ``err=None`` it adds no checkpoint leaf."""
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

    def _named_leaves(self):
        yield "opt/step", np.asarray(self.opt.step, np.int32)
        for name, t in self._group_leaves():
            yield name, t.detach().cpu().numpy()
        for k, dtype in _LOSS_SCALE_LEAVES:
            yield f"loss_scale/{k}", np.asarray(getattr(self.loss_scale, k),
                                                dtype)

    def checkpoint_leaves(self) -> List[Tuple[str, np.ndarray]]:
        """The state as the reference's checkpoint holds it: (name, numpy
        array) in its leaf order -- ``opt/step`` (int32), master, m and v
        (float32, a block leaf stacked over the layers), then the loss
        scale (float32, int32, int32).  On the CPU the group arrays share
        memory with the state."""
        return list(self._named_leaves())

    def digest(self) -> str:
        """sha256 over every leaf's name and bytes, in
        ``checkpoint_leaves`` order (one leaf on the host at a time): two
        ranks (or runs) hold the same state exactly when their digests
        agree."""
        h = hashlib.sha256()
        for name, a in self._named_leaves():
            h.update(name.encode() + b"\0")
            h.update(np.ascontiguousarray(a))
        return h.hexdigest()

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
                   impl: Optional[str] = None,
                   grad_reduce: Optional[Callable] = None):
    """The gradient part of a step: the compute copy of the master weights,
    the scaled loss over the micro-batches, unscaled fp32 gradients.
    ``grad_reduce`` (data parallelism) takes a list of tensors and returns
    them reduced; it runs on the loss-scaled gradients, then on the loss,
    before the unscale, in the reference's order (so a non-finite gradient
    on any rank reaches every rank).  Returns (loss (0-d fp32, unscaled),
    {group path: flat fp32 grad}, metrics of the last micro-batch)."""
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
    if grad_reduce is not None:
        grads = dict(zip(grads, grad_reduce(list(grads.values()))))
        (loss,) = grad_reduce([loss])
    grads = loss_scale.unscale_grads(grads, state.loss_scale)
    return loss / state.loss_scale.scale, grads, metrics


def train_step_fn(state: TrainState, batch, *, cfg: ModelConfig,
                  tcfg: TrainConfig, policy: Policy,
                  impl: Optional[str] = None,
                  grad_reduce: Optional[Callable] = None,
                  metric_reduce: Optional[Callable] = None):
    """One optimizer step on ``batch`` (a dict of (global batch, ...)
    integer tensors on the card).  Updates ``state`` in place, all at once
    after the last operation that can fail, and returns (state, metrics):
    loss, grad_norm, lr, loss_scale, skipped and the loss function's
    metrics.  ``impl`` is passed to the kernels (``kernels/ops.py``);
    ``grad_reduce`` (see ``step_gradients``) and ``metric_reduce`` (the
    loss function's metrics dict -> its mean over the ranks) are the
    data-parallel hooks, None on one card."""
    tcfg.check_supported()
    loss, grads, metrics = step_gradients(state, batch, cfg=cfg, tcfg=tcfg,
                                          policy=policy, impl=impl,
                                          grad_reduce=grad_reduce)
    if metric_reduce is not None:
        metrics = metric_reduce(metrics)
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


# ---------------------------------------------------------------------------
# Pure data parallelism (the paper's BERT runs): explicit collectives
# ---------------------------------------------------------------------------

def make_train_step_dp(cfg: ModelConfig, tcfg: TrainConfig, mesh, *,
                       impl: Optional[str] = None) -> Callable:
    """``step(state, global_batch) -> (state, metrics)`` on every rank of
    ``mesh`` (a ``launch.mesh.DPMesh``), the reference's
    ``make_train_step_dp`` with ranks for devices.

    Each rank takes its contiguous rows of the global batch (rank r the
    r-th of ``world`` blocks, ``rank = pod * n_fast + fast`` as the
    reference's batch sharding linearises its devices) and runs
    ``train_step_fn`` on them.  The loss-scaled accumulated gradients and
    then the loss are summed with ``tcfg.collective_strategy`` and divided
    by the world size, before the unscale and the finite check; the loss
    function's floating metrics are summed and divided by the world size.
    Every rank then holds the same gradients, takes the same skip and
    loss-scale decision and makes the same update: the state stays
    replicated bit for bit.

    ``step.exchange_s`` holds the seconds of the last call's exchange on
    this rank: the reduces and divisions of the gradients and the loss,
    timed with CUDA events on the card (read after the step's finite
    check has waited for them) and with the host clock otherwise."""
    tcfg.check_supported()
    policy = make_policy(tcfg.precision)
    world = mesh.world
    on_card = mesh.device.type == "cuda"
    spans = []

    def mark():
        if not on_card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def grad_reduce(tree):
        t0 = mark()
        tree = C.reduce_gradients(tree, strategy=tcfg.collective_strategy,
                                  mesh=mesh, bucket_bytes=tcfg.bucket_bytes)
        tree = [x.div_(world) for x in tree]
        spans.append((t0, mark()))
        return tree

    def metric_reduce(metrics):
        names = [k for k, v in metrics.items()
                 if torch.is_tensor(v) and v.is_floating_point()]
        if not names or mesh.group is None:
            return metrics
        # one exchange for all of them (an all-reduce is elementwise)
        mean = C.psum(torch.stack([metrics[k].float() for k in names]),
                      mesh.group).div_(world)
        return {**metrics, **dict(zip(names, mean.unbind()))}

    def step(state: TrainState, global_batch):
        b = next(iter(global_batch.values())).shape[0]
        if b % (world * tcfg.accum_steps):
            raise ValueError(f"global batch {b} is not divisible by world "
                             f"{world} x accum_steps {tcfg.accum_steps}")
        rows = slice(mesh.rank * (b // world), (mesh.rank + 1) * (b // world))
        local = {k: v[rows] for k, v in global_batch.items()}
        spans.clear()
        out = train_step_fn(state, local, cfg=cfg, tcfg=tcfg, policy=policy,
                            impl=impl, grad_reduce=grad_reduce,
                            metric_reduce=metric_reduce)
        step.exchange_s = sum(t0.elapsed_time(t1) / 1e3 if on_card
                              else t1 - t0 for t0, t1 in spans)
        return out
    step.exchange_s = None
    return step
