"""Training step (port of ``repro/train/train_step.py``): the paper's
optimization stack composed.

    loss -> [dynamic loss scale] -> grad over [accum_steps micro-batches]
         -> [gradient exchange: psum | ring | hierarchical | bucketed,
             uncompressed or fp16/int8 with error feedback, serial or
             overlapped with the last backward]
         -> unscale -> finite check -> clip -> [LAMB | AdamW] with fp32
            master weights

``train_step_fn`` is the step on one card.  ``make_train_step_dp`` is the
reference's pure data parallelism (``shard_map`` over the data axes, the
model replicated, the exchange explicit), with each device a rank of
``torch.distributed`` (``launch/mesh.py``): each rank takes its
contiguous rows of the global batch and the step's hooks run the exchange
(``core/collectives.py``): ``grad_reduce`` and ``metric_reduce`` (the
serial uncompressed exchange), ``grad_exchange`` (the compressed one) and
``overlap_reduce`` (the overlapped drain's, uncompressed).

Host and device.  PyTorch runs eagerly, so the step reads two host values
from the card each step: the finite flag (one sync, which decides the
skip and the loss-scale update on the host) and nothing else until the
caller reads the metrics.  A skipped step launches no optimizer kernel, so
master weights, moments and step count stay bit-identical.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import collectives as C
from repro_torch.core.amp import (LossScaleState, Policy, make_loss_scale,
                                  make_policy)
from repro_torch.core.grad_accum import accumulate_gradients
from repro_torch.models import api
from repro_torch.optim import (LambState, adamw_update, lamb_init,
                               lamb_update)
from repro_torch.optim import warmup_poly_decay
from repro_torch.utils import Path, all_finite, global_norm, tree_map

# the loss-scale leaves of a checkpoint, in the reference's order and dtypes
_LOSS_SCALE_LEAVES = (("scale", np.float32), ("good_steps", np.int32),
                      ("total_skipped", np.int32))


@dataclasses.dataclass
class TrainState:
    """The optimizer state and the loss scale, replicated on every rank of
    a data-parallel run, and ``err``: this rank's residual of the
    compressed exchange (the reference's ``TrainState.err``), one flat fp32
    buffer per ``LeafGroups`` path, or None when compression is off (then
    it adds no checkpoint leaf, as the reference's ``err=None``).  The
    residual is per rank: a checkpoint holds every rank's, as one more leaf
    group after the loss scale, each leaf ``(world, *reference leaf)``;
    ``world`` and ``rank`` say which row is this rank's."""
    opt: LambState
    loss_scale: LossScaleState
    err: Optional[Dict[Path, torch.Tensor]] = None
    world: int = 1
    rank: int = 0

    def _group_leaves(self):
        """(name, (L, *leaf) view) of every optimizer group: master, m, v,
        each in ``LeafGroups.paths`` order."""
        groups = self.opt.groups
        for kind in ("master", "m", "v"):
            stacked = groups.stacked(getattr(self.opt, kind))
            for path in groups.paths:
                yield f"opt/{kind}/" + groups.name(path), stacked[path]

    def _err_shapes(self):
        """(name, path, (world, L, *leaf)) of every residual leaf."""
        groups = self.opt.groups
        for path, view in groups.stacked(self.opt.master).items():
            yield ("err/" + groups.name(path), path,
                   (self.world,) + tuple(view.shape))

    def _named_leaves(self):
        yield "opt/step", np.asarray(self.opt.step, np.int32)
        for name, t in self._group_leaves():
            yield name, t.detach().cpu().numpy()
        for k, dtype in _LOSS_SCALE_LEAVES:
            yield f"loss_scale/{k}", np.asarray(getattr(self.loss_scale, k),
                                                dtype)

    def checkpoint_leaves(self, err_rows=None
                          ) -> List[Tuple[str, np.ndarray]]:
        """The state as the reference's checkpoint holds it: (name, numpy
        array) in its leaf order -- ``opt/step`` (int32), master, m and v
        (float32, a block leaf stacked over the layers), the loss scale
        (float32, int32, int32), then, with compression on, the residual
        of every rank (float32, ``(world, *leaf)``).  ``err_rows`` are
        every rank's residual buffers, {path: (world, numel) array}
        (``gather_residual``); at world 1 this rank's own are taken.  On
        the CPU the group arrays share memory with the state."""
        out = list(self._named_leaves())
        if self.err is None:
            return out
        if err_rows is None:
            if self.world != 1:
                raise ValueError(f"a checkpoint of world {self.world} needs "
                                 "every rank's residual (gather_residual)")
            err_rows = {p: e.detach().cpu().numpy()[None]
                        for p, e in self.err.items()}
        return out + [(name, err_rows[path].reshape(shape))
                      for name, path, shape in self._err_shapes()]

    def digest(self) -> str:
        """sha256 over every replicated leaf's name and bytes, in
        ``checkpoint_leaves`` order (one leaf on the host at a time; the
        residual is not replicated and has ``residual_digest``): two ranks
        (or runs) hold the same state exactly when their digests agree."""
        h = hashlib.sha256()
        for name, a in self._named_leaves():
            h.update(name.encode() + b"\0")
            h.update(np.ascontiguousarray(a))
        return h.hexdigest()

    def residual_digest(self) -> Optional[str]:
        """sha256 over this rank's residual buffers, or None without one."""
        if self.err is None:
            return None
        h = hashlib.sha256()
        for path in self.opt.groups.paths:
            h.update("/".join(path).encode() + b"\0")
            h.update(np.ascontiguousarray(
                self.err[path].detach().cpu().numpy()))
        return h.hexdigest()

    def load_checkpoint_leaves(self, leaves) -> None:
        """Load (name, numpy array) pairs as ``checkpoint_leaves`` gives
        them, in place: each group buffer is copied into where it lies (the
        tensors stay on their device), and this rank's row of each residual
        leaf into its residual.  Names, shapes and dtypes are all checked
        before anything is written; a mismatch raises ``ValueError`` (a
        residual group where this state has none or the other way round,
        and a residual of another world, each said so)."""
        leaves = list(leaves)
        views = list(self._group_leaves())
        errs = [] if self.err is None else list(self._err_shapes())
        want = ([("opt/step", (), np.int32)]
                + [(n, tuple(t.shape), np.float32) for n, t in views]
                + [(f"loss_scale/{k}", (), dtype)
                   for k, dtype in _LOSS_SCALE_LEAVES]
                + [(n, shape, np.float32) for n, _, shape in errs])
        names = [n for n, _ in leaves]
        if names != [n for n, _, _ in want]:
            has = any(n.startswith("err/") for n in names)
            why = ""
            if has != bool(errs):
                why = (" (the checkpoint holds a compressed exchange's "
                       "residual group and this state has none)" if has else
                       " (this state has a compressed exchange's residual "
                       "group and the checkpoint has none)")
            raise ValueError(
                f"checkpoint leaves {names[:4]}... (of {len(leaves)}) are "
                f"not this state's {[n for n, _, _ in want][:4]}... (of "
                f"{len(want)}){why}")
        for (name, a), (_, shape, dtype) in zip(leaves, want):
            if name.startswith("err/") and a.ndim and a.shape[0] != \
                    self.world and a.shape[1:] == shape[1:]:
                raise ValueError(
                    f"leaf {name}: the checkpoint holds the residuals of "
                    f"world {a.shape[0]}, this run's world is {self.world}")
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(f"leaf {name}: {a.dtype} {a.shape}, "
                                 f"expected {np.dtype(dtype)} {shape}")
        arrays = [a for _, a in leaves]
        n_opt = 1 + len(views)
        for (_, view), a in zip(views, arrays[1:n_opt]):
            view.copy_(torch.from_numpy(a))
        for (_, path, _), a in zip(errs, arrays[n_opt + 3:]):
            self.err[path].copy_(torch.from_numpy(
                np.ascontiguousarray(a[self.rank])).reshape(-1))
        self.opt.step = int(arrays[0])
        ls = arrays[n_opt:n_opt + 3]
        self.loss_scale = LossScaleState(float(ls[0]), int(ls[1]),
                                         int(ls[2]))


def gather_residual(state: TrainState, mesh) -> Optional[dict]:
    """Every rank's residual on rank 0, {path: (world, numel) float32
    numpy array}, for its checkpoint; None on the other ranks.  Every rank
    of ``mesh`` must call it (one gather a group, over the world group;
    a card's buffer is staged through host memory under gloo)."""
    out = {} if mesh.rank == 0 else None
    for path in state.opt.groups.paths:
        h = C._host(state.err[path], mesh.group)
        rows = ([torch.empty_like(h) for _ in range(mesh.world)]
                if mesh.rank == 0 else None)
        dist.gather(h, rows, dst=0, group=mesh.group)
        if out is not None:
            out[path] = torch.stack(rows).cpu().numpy()
    return out


class ResidualRows:
    """A ``TrainState`` with every rank's residual rows, as
    ``save_checkpoint`` takes it (``checkpoint_leaves``)."""

    def __init__(self, state: TrainState, rows: Optional[dict]):
        self.state, self.rows = state, rows

    def checkpoint_leaves(self):
        return self.state.checkpoint_leaves(self.rows)


def init_train_state(params: dict, policy: Policy, tcfg: TrainConfig, *,
                     cfg: Optional[ModelConfig], world: int = 1,
                     rank: int = 0) -> TrainState:
    """fp32 master weights and zero moments from model ``cfg``'s parameter
    tree (any dtype; copied; ``cfg`` None for a tree that is no model),
    grouped as the reference stacks it (``LeafGroups``), the policy's
    initial loss scale and, with compression on, a zero residual for rank
    ``rank`` of ``world``."""
    tcfg.check_supported()
    opt = lamb_init(params, cfg)
    err = None
    if tcfg.grad_compression != "none":
        err = {p: torch.zeros_like(t) for p, t in opt.master.items()}
    return TrainState(opt, make_loss_scale(policy).init(), err, world, rank)


def _optimizer_update(grads, opt: LambState, tcfg: TrainConfig, *,
                      skip_update: bool, impl=None):
    lr = warmup_poly_decay(opt.step + 1, base_lr=tcfg.learning_rate,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
    if tcfg.optimizer == "lamb":
        return lamb_update(grads, opt, lr=lr, wd=tcfg.weight_decay,
                           skip_update=skip_update, impl=impl), lr
    return adamw_update(grads, opt, lr=lr, wd=tcfg.weight_decay,
                        skip_update=skip_update), lr


def _clip_grads(grads: dict, max_norm: float):
    """Scale every gradient by min(1, max_norm / ||g||), in place; returns
    (grads, the global norm before clipping)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, gnorm


def _scaled_gradients(state: TrainState, batch, *, cfg: ModelConfig,
                      tcfg: TrainConfig, policy: Policy, impl=None,
                      exchange=None):
    """The compute copy of the master weights and the scaled loss over the
    micro-batches: (mean scaled loss, {group path: flat fp32 gradient mean}
    or, with ``exchange``, the drain's result, metrics of the last
    micro-batch)."""
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

    return accumulate_gradients(scaled_loss, params, opt.groups, batch,
                                tcfg.accum_steps, exchange=exchange)


def step_gradients(state: TrainState, batch, *, cfg: ModelConfig,
                   tcfg: TrainConfig, policy: Policy,
                   impl: Optional[str] = None,
                   grad_reduce: Optional[Callable] = None):
    """The gradient part of a step in the serial uncompressed schedule:
    the compute copy of the master weights, the scaled loss over the
    micro-batches, unscaled fp32 gradients.  ``grad_reduce`` (data
    parallelism) takes a list of tensors and returns them reduced; it runs
    on the loss-scaled gradients, then on the loss, before the unscale, in
    the reference's order (so a non-finite gradient on any rank reaches
    every rank).  Returns (loss (0-d fp32, unscaled), {group path: flat
    fp32 grad}, metrics of the last micro-batch)."""
    loss, grads, metrics = _scaled_gradients(state, batch, cfg=cfg,
                                             tcfg=tcfg, policy=policy,
                                             impl=impl)
    if grad_reduce is not None:
        grads = dict(zip(grads, grad_reduce(list(grads.values()))))
        (loss,) = grad_reduce([loss])
    grads = make_loss_scale(policy).unscale_grads(grads, state.loss_scale)
    return loss / state.loss_scale.scale, grads, metrics


def train_step_fn(state: TrainState, batch, *, cfg: ModelConfig,
                  tcfg: TrainConfig, policy: Policy,
                  impl: Optional[str] = None,
                  grad_reduce: Optional[Callable] = None,
                  metric_reduce: Optional[Callable] = None,
                  grad_exchange: Optional[Callable] = None,
                  overlap_reduce=None,
                  on_grads: Optional[Callable] = None):
    """One optimizer step on ``batch`` (a dict of (global batch, ...)
    integer tensors on the card).  Updates ``state`` in place, all at once
    after the last operation that can fail, and returns (state, metrics):
    loss, grad_norm, lr, loss_scale, skipped and the loss function's
    metrics.  ``impl`` is passed to the kernels (``kernels/ops.py``).

    The data-parallel hooks, None on one card (the reference's):
    ``grad_reduce`` (see ``step_gradients``) and ``metric_reduce`` (the
    loss function's metrics dict -> its mean over the ranks);
    ``grad_exchange``, the compressed exchange, ``(unscaled grads, err) ->
    (mean grads, new err, finite)`` over lists in ``LeafGroups.paths``
    order, which replaces the reduce, unscale and finite check of the
    gradients (unscaling first, so the residual lives in true gradient
    units); ``overlap_reduce``, the uncompressed drain exchange
    (``core/grad_accum.py``: ``buckets``, ``start``, ``finish``), run in
    the last micro-batch's backward, whose result is the mean, still
    loss-scaled.  With ``tcfg.overlap_exchange`` and compression on, the
    compressed branch runs: the reference's compressed drain starts
    nothing early (its first operation, the all-ranks finite flag, reads
    every buffer, so it waits for the whole backward), and its mean,
    unscale and exchange are the compressed branch's, in bits.  The
    branches: compressed (overlapped or not), overlap, serial.
    ``on_grads`` (a check's hook) sees the mean unscaled gradients the
    clip takes.

    On one card (no hook) compression and overlap raise ``ValueError``:
    they need ``make_train_step_dp``'s explicit exchange."""
    tcfg.check_supported()
    if grad_exchange is None and tcfg.grad_compression != "none":
        raise ValueError("grad_compression requires the explicit-collective "
                         "data-parallel step (make_train_step_dp): the "
                         "single-card step has no exchange to compress")
    if grad_exchange is not None and state.err is None:
        raise ValueError("the compressed exchange needs the state's "
                         "residual: build the state with init_train_state "
                         "and grad_compression on")
    if overlap_reduce is None and grad_exchange is None and \
            tcfg.overlap_exchange:
        raise ValueError("overlap_exchange requires the explicit-collective "
                         "data-parallel step (make_train_step_dp): the "
                         "single-card step has no exchange to overlap")
    loss_scale = make_loss_scale(policy)
    paths = state.opt.groups.paths
    kw = dict(cfg=cfg, tcfg=tcfg, policy=policy, impl=impl)
    new_err = state.err
    err = None if state.err is None else [state.err[p] for p in paths]

    def reduce_loss(loss):
        if grad_reduce is not None:
            (loss,) = grad_reduce([loss])
        return loss / state.loss_scale.scale

    if grad_exchange is not None:
        loss, grads, metrics = _scaled_gradients(state, batch, **kw)
        grads = loss_scale.unscale_grads([grads[p] for p in paths],
                                         state.loss_scale)
        grads, new_err, finite = grad_exchange(grads, err)
        loss = reduce_loss(loss)
    elif tcfg.overlap_exchange:
        # the mean arrives reduced (loss-scaled): finish as the serial path
        loss, grads, metrics = _scaled_gradients(
            state, batch, exchange=overlap_reduce, **kw)
        loss = reduce_loss(loss)
        grads = loss_scale.unscale_grads(grads, state.loss_scale)
        finite = all_finite(grads)
    else:
        loss, grads, metrics = step_gradients(state, batch,
                                              grad_reduce=grad_reduce, **kw)
        finite = all_finite(grads)
    if not isinstance(grads, dict):
        grads = dict(zip(paths, grads))
    if new_err is not None and not isinstance(new_err, dict):
        new_err = dict(zip(paths, new_err))
    if metric_reduce is not None:
        metrics = metric_reduce(metrics)
    finite = bool(finite)
    if on_grads is not None:
        on_grads(grads)
    new_ls, _ = loss_scale.update(state.loss_scale, finite)
    grads, gnorm = _clip_grads(grads, tcfg.grad_clip)
    # the optimizer swaps its new tensors and step in at its end, and the
    # loss scale and residual follow: a step that raises leaves the state
    # as it was
    state.opt, lr = _optimizer_update(grads, state.opt, tcfg,
                                      skip_update=not finite, impl=impl)
    state.loss_scale = new_ls
    state.err = new_err
    out = {"loss": loss.float(), "grad_norm": gnorm, "lr": lr,
           "loss_scale": new_ls.scale, "skipped": not finite}
    out.update(metrics)
    return state, out


# ---------------------------------------------------------------------------
# Pure data parallelism (the paper's BERT runs): explicit collectives
# ---------------------------------------------------------------------------

class _TimedDrain:
    """An overlapped exchange timed from its first bucket's start to the
    end of its wait (one span a step), its start order kept."""

    def __init__(self, drain, mark: Callable, spans: list):
        self.drain, self.mark, self.spans = drain, mark, spans
        self.order: List[int] = []
        self._t0, self._buckets = None, []

    def buckets(self, bufs):
        self._buckets = self.drain.buckets(bufs)
        self.order, self._t0 = [], None
        return self._buckets

    def start(self, bucket, bufs, inv):
        if self._t0 is None:
            self._t0 = self.mark()
        self.order.append(self._buckets.index(bucket))
        self.drain.start(bucket, bufs, inv)

    def finish(self, bufs, inv):
        t0 = self._t0 if self._t0 is not None else self.mark()
        out = self.drain.finish(bufs, inv)
        self.spans.append((t0, self.mark()))
        return out


def make_train_step_dp(cfg: ModelConfig, tcfg: TrainConfig, mesh, *,
                       impl: Optional[str] = None,
                       keep_grads: bool = False) -> Callable:
    """``step(state, global_batch) -> (state, metrics)`` on every rank of
    ``mesh`` (a ``launch.mesh.DPMesh``), the reference's
    ``make_train_step_dp`` with ranks for devices.

    Each rank takes its contiguous rows of the global batch (rank r the
    r-th of ``world`` blocks, ``rank = pod * n_fast + fast`` as the
    reference's batch sharding linearises its devices) and runs
    ``train_step_fn`` on them with the reference's hooks:

    * ``grad_reduce``: the loss-scaled accumulated gradients, then the
      loss, summed with ``tcfg.collective_strategy`` and divided by the
      world size (``"local"``, the timing breakdown's calibration twin,
      sums nothing and still divides: the ranks then diverge);
    * ``metric_reduce``: the loss function's floating metrics summed and
      divided by the world size;
    * ``grad_exchange`` (``tcfg.grad_compression`` fp16 or int8):
      ``collectives.compressed_reduce_gradients`` of the unscaled
      gradients with this rank's residual (``state.err``), divided by the
      world size;
    * ``overlap_reduce`` (``tcfg.overlap_exchange``, uncompressed):
      ``collectives.OverlappedReduce``, the mean a bucket at a time during
      the last backward (the 1/A mean folded into it).

    Every rank then holds the same gradients, takes the same skip and
    loss-scale decision and makes the same update: the state stays
    replicated bit for bit (the residual excepted).

    ``step.exchange_s`` holds the seconds of the last call's exchange on
    this rank: the reduces and divisions of the gradients and the loss
    (under overlap, the first bucket's start to the last bucket's wait;
    with compression, the whole compressed exchange), timed with CUDA
    events on the card (read after the step's finite check has waited for
    them) and with the host clock otherwise.  ``step.compress_s`` holds
    its seconds of local quantise and dequantise work, ``{"quantise": s,
    "dequantise": s}`` (empty without compression), ``step.bucket_order``
    the buckets the overlapped drain started from the backward's hooks,
    in order, ``step.n_buckets`` the drain's bucket count, and with
    ``keep_grads`` ``step.grads`` a host copy of the mean unscaled
    gradients the clip took (the check of ``launch/dp_check.py``)."""
    tcfg.check_supported()
    policy = make_policy(tcfg.precision)
    world = mesh.world
    strategy = tcfg.collective_strategy
    on_card = mesh.device.type == "cuda"
    spans, local = [], collections.defaultdict(list)

    def mark():
        if not on_card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(t0, t1):
        return t0.elapsed_time(t1) / 1e3 if on_card else t1 - t0

    @contextlib.contextmanager
    def span(name):
        t0 = mark()
        yield
        local[name].append((t0, mark()))

    def grad_reduce(tree):
        t0 = mark()
        if strategy != "local":
            tree = C.reduce_gradients(tree, strategy=strategy, mesh=mesh,
                                      bucket_bytes=tcfg.bucket_bytes)
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

    grad_exchange = None
    if tcfg.grad_compression != "none":
        def grad_exchange(grads, err):
            t0 = mark()
            red, new_err, fin = C.compressed_reduce_gradients(
                grads, err, strategy=strategy, mode=tcfg.grad_compression,
                mesh=mesh, bucket_bytes=tcfg.bucket_bytes, span=span)
            red = [x.div_(world) for x in red]
            spans.append((t0, mark()))
            return red, new_err, fin

    drain = None
    if tcfg.overlap_exchange and grad_exchange is None:
        drain = _TimedDrain(C.OverlappedReduce(
            strategy=strategy, mesh=mesh, bucket_bytes=tcfg.bucket_bytes,
            world=world), mark, spans)

    def keep(grads):   # on the host: ranks sharing a card lack the room
        step.grads = {p: g.detach().to("cpu", copy=True)
                      for p, g in grads.items()}

    def step(state: TrainState, global_batch):
        b = next(iter(global_batch.values())).shape[0]
        if b % (world * tcfg.accum_steps):
            raise ValueError(f"global batch {b} is not divisible by world "
                             f"{world} x accum_steps {tcfg.accum_steps}")
        if state.err is not None and (state.world, state.rank) != (
                world, mesh.rank):
            raise ValueError(f"the state's residual is rank {state.rank} of "
                             f"world {state.world}, the mesh's rank "
                             f"{mesh.rank} of {world}")
        rows = slice(mesh.rank * (b // world), (mesh.rank + 1) * (b // world))
        local_batch = {k: v[rows] for k, v in global_batch.items()}
        spans.clear()
        local.clear()
        out = train_step_fn(state, local_batch, cfg=cfg, tcfg=tcfg,
                            policy=policy, impl=impl, grad_reduce=grad_reduce,
                            metric_reduce=metric_reduce,
                            grad_exchange=grad_exchange,
                            overlap_reduce=drain,
                            on_grads=keep if keep_grads else None)
        step.exchange_s = sum(seconds(*s) for s in spans)
        step.compress_s = {k: sum(seconds(*s) for s in v)
                           for k, v in local.items()}
        if drain is not None:
            step.bucket_order = list(drain.order)
            step.n_buckets = len(drain._buckets)
        return out
    step.exchange_s, step.compress_s, step.bucket_order = None, {}, None
    step.n_buckets = None
    step.grads = None
    return step
