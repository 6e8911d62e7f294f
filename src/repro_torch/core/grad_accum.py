"""Gradient accumulation, serial schedule (port of
``repro/core/grad_accum.py:55-122``; paper §4.4, Fig. 5).

The global batch is split into ``accum_steps`` micro-batches; each one's
gradient is summed in fp32 and the sum is scaled by 1/A once at the end:

    grads = (1/A) * (((g_0 + g_1) + g_2) + ... + g_{A-1})

the reference's summation order.  The sums live in one flat fp32 buffer
per leaf group (``utils.LeafGroups``), the layout the optimizer takes.  The
loss is the mean over micro-batches, the metrics are the last
micro-batch's.  The exchange hook of the overlapped drain schedule comes
with the data-parallel slice.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.utils import LeafGroups, Path, tree_leaves


def split_microbatches(batch: Dict[str, torch.Tensor], accum_steps: int
                       ) -> List[Dict[str, torch.Tensor]]:
    """(B, ...) leaves -> ``accum_steps`` micro-batches of (B/A, ...)."""
    b = next(iter(batch.values())).shape[0]
    if b % accum_steps:
        raise ValueError(f"global batch {b} not divisible by accum_steps "
                         f"{accum_steps}")
    return [{k: v.reshape(accum_steps, b // accum_steps, *v.shape[1:])[a]
             for k, v in batch.items()} for a in range(accum_steps)]


def accumulate_gradients(loss_fn: Callable, params: dict, groups: LeafGroups,
                         batch: Dict[str, torch.Tensor], accum_steps: int
                         ) -> Tuple[torch.Tensor, Dict[Path, torch.Tensor],
                                    dict]:
    """Run ``loss_fn(params, microbatch) -> (loss, aux)`` and its gradient
    over ``accum_steps`` micro-batches.  ``params`` is a tree of leaves that
    require grad, laid out by ``groups``.  Returns (mean loss as a 0-d
    fp32 tensor, {group path: flat fp32 gradient}, last aux)."""
    leaves = tree_leaves(params)
    grads = {p: torch.empty(groups.numel(p), dtype=torch.float32,
                            device=leaves[0].device) for p in groups.paths}
    views = tree_leaves(groups.tree(grads))
    loss_sum, aux = None, None
    for a, mb in enumerate(split_microbatches(batch, accum_steps)):
        loss, aux = loss_fn(params, mb)
        gs = torch.autograd.grad(loss, leaves)
        for view, g in zip(views, gs):
            if a == 0:
                view.copy_(g)
            else:
                view.add_(g.float())
        loss = loss.detach().float()
        loss_sum = loss if loss_sum is None else loss_sum + loss
    if accum_steps > 1:
        inv = 1.0 / accum_steps
        for g in grads.values():
            g.mul_(inv)
        loss_sum = loss_sum * inv
    return loss_sum, grads, aux
