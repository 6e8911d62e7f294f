"""Gradient accumulation and the overlapped drain schedule (port of
``repro/core/grad_accum.py``; paper §4.4, Fig. 5).

The global batch is split into ``accum_steps`` micro-batches; each one's
gradient is summed in fp32 and the sum is scaled by 1/A once at the end:

    grads = (1/A) * (((g_0 + g_1) + g_2) + ... + g_{A-1})

the reference's summation order.  The sums live in one flat fp32 buffer
per leaf group (``utils.LeafGroups``), the layout the optimizer takes.  The
loss is the mean over micro-batches, the metrics are the last
micro-batch's.

**Serial schedule** (``exchange=None``): the exchange runs after this
function returns, on the whole mean.

**Overlapped drain schedule** (``exchange`` given, ``TrainConfig.
overlap_exchange``): micro-batches 0 .. A-2 accumulate as above.  The last
one's gradients arrive through hooks on the leaf tensors
(``Tensor.register_hook``), which fire as the backward produces each
leaf's gradient; a hook adds it into the same view, by the same operation,
as the serial path, so the local sums keep their bits.  A group is
complete once every layer's leaf has arrived; once every group of one of
``exchange.buckets(buffers)`` is complete, the hook calls
``exchange.start(bucket, buffers, inv)``, during the backward, and after
it ``exchange.finish(buffers, inv)`` waits for every bucket and returns
the result, passed on opaquely.  ``inv`` is 1/A, or None at A = 1, where
the serial path applies no mean either.  Hooks fire in the graph's
order, the same on every rank, so every rank starts its buckets in the
same order (each start is logged at debug level, and the train step
keeps the order for a check across ranks).

A block group's gradient is complete only when layer 0's backward has run,
so nearly every bucket of the BERT tree starts near the end of the last
backward; only the embeddings' backward is left to hide behind.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.utils import LeafGroups, tree_leaves

logger = logging.getLogger("repro_torch.grad_accum")


def split_microbatches(batch: Dict[str, torch.Tensor], accum_steps: int
                       ) -> List[Dict[str, torch.Tensor]]:
    """(B, ...) leaves -> ``accum_steps`` micro-batches of (B/A, ...)."""
    b = next(iter(batch.values())).shape[0]
    if b % accum_steps:
        raise ValueError(f"global batch {b} not divisible by accum_steps "
                         f"{accum_steps}")
    return [{k: v.reshape(accum_steps, b // accum_steps, *v.shape[1:])[a]
             for k, v in batch.items()} for a in range(accum_steps)]


def _add_into(view: torch.Tensor, g: torch.Tensor, first: bool) -> None:
    if first:
        view.copy_(g)
    else:
        view.add_(g.float())


def _drain_backward(loss, leaves, views, bufs, first, exchange, inv) -> None:
    """The last micro-batch's backward with the exchange started a bucket
    at a time from the leaves' hooks."""
    # view j lies in buffer owner[j]; buffer i waits for left[i] views
    of_storage = {b.untyped_storage().data_ptr(): i
                  for i, b in enumerate(bufs)}
    owner = [of_storage[v.untyped_storage().data_ptr()] for v in views]
    left = [owner.count(i) for i in range(len(bufs))]
    buckets = exchange.buckets(bufs)
    waiting = [set(b) for b in buckets]
    bucket_of = {i: k for k, b in enumerate(buckets) for i in b}

    def hook(j):
        def fn(g):
            _add_into(views[j], g, first)
            i = owner[j]
            left[i] -= 1
            if left[i] == 0 and i in bucket_of:
                k = bucket_of[i]
                waiting[k].discard(i)
                if not waiting[k]:
                    logger.debug("drain: bucket %d of %d started", k,
                                 len(buckets))
                    exchange.start(buckets[k], bufs, inv)
        return fn

    handles = [leaf.register_hook(hook(j)) for j, leaf in enumerate(leaves)]
    try:
        torch.autograd.grad(loss, leaves)
    finally:
        for h in handles:
            h.remove()


def accumulate_gradients(loss_fn: Callable, params: dict, groups: LeafGroups,
                         batch: Dict[str, torch.Tensor], accum_steps: int,
                         exchange=None) -> Tuple[torch.Tensor, object, dict]:
    """Run ``loss_fn(params, microbatch) -> (loss, aux)`` and its gradient
    over ``accum_steps`` micro-batches.  ``params`` is a tree of leaves that
    require grad, laid out by ``groups``.  Returns (mean loss as a 0-d
    fp32 tensor, {group path: flat fp32 gradient} or, with ``exchange``,
    ``exchange.finish``'s result, last aux); see the module docstring for
    ``exchange``."""
    leaves = tree_leaves(params)
    grads = {p: torch.empty(groups.numel(p), dtype=torch.float32,
                            device=leaves[0].device) for p in groups.paths}
    views = tree_leaves(groups.tree(grads))
    loss_sum, aux = None, None
    for a, mb in enumerate(split_microbatches(batch, accum_steps)):
        loss, aux = loss_fn(params, mb)
        if exchange is not None and a == accum_steps - 1:
            _drain_backward(loss, leaves, views, list(grads.values()), a == 0,
                            exchange,
                            1.0 / accum_steps if accum_steps > 1 else None)
        else:
            gs = torch.autograd.grad(loss, leaves)
            for view, g in zip(views, gs):
                _add_into(view, g, a == 0)
            del gs
        loss = loss.detach().float()
        loss_sum = loss if loss_sum is None else loss_sum + loss
    inv = 1.0 / accum_steps if accum_steps > 1 else None
    if inv is not None:
        loss_sum = loss_sum * inv
    if exchange is not None:
        return loss_sum, exchange.finish(list(grads.values()), inv), aux
    if inv is not None:
        for g in grads.values():
            g.mul_(inv)
    return loss_sum, grads, aux
