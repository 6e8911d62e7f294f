"""LAMB (You et al., the paper's ref [24]; port of ``repro/optim/lamb.py``).

fp32 master weights and moments, the layer-wise trust ratio
||w|| / ||update||, decoupled weight decay.  The elementwise part of each
step is the fused moment kernel (``kops.lamb_leaf_update``: the paper's
§4.3 APEX fusion, ``csrc/lamb_update.cu`` on the card); the two norms and
``w - lr * trust * update`` are torch reductions and ops, as the
reference leaves them to XLA.

The state is kept per leaf group (``utils.LeafGroups``): one flat fp32
buffer per leaf name, holding that leaf of every layer.  The reference
stacks block leaves over the layers, so its trust ratio is taken over all
24 layers' ``wq`` together, say; a ratio per layer tensor (APEX's choice)
would give a different step.  Grouping the port's per-layer tensors the
same way keeps the reference's step, and makes each group one kernel
launch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.utils import LeafGroups, Path


@dataclasses.dataclass
class LambState:
    step: int                            # updates applied so far
    groups: LeafGroups                   # layout of the parameter tree
    master: Dict[Path, torch.Tensor]     # fp32 master weights, flat per group
    m: Dict[Path, torch.Tensor]          # fp32 first moment
    v: Dict[Path, torch.Tensor]          # fp32 second moment


def lamb_init(params: dict, cfg=None) -> LambState:
    """fp32 master copy of a parameter tree and zero moments, grouped as
    the reference stacks model ``cfg``'s (``LeafGroups``)."""
    groups = LeafGroups(params, cfg)
    master = groups.flatten(params, torch.float32)
    zeros = lambda: {p: torch.zeros_like(t) for p, t in master.items()}
    return LambState(0, groups, master, zeros(), zeros())


def lamb_update(grads: Dict[Path, torch.Tensor], state: LambState, *,
                lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-6, wd: float = 0.01,
                skip_update: bool = False,
                impl: Optional[str] = None) -> LambState:
    """One LAMB step over every group.  ``grads``: flat fp32 buffers by
    group path.  ``skip_update`` (a non-finite gradient under dynamic loss
    scaling) returns the state as it is: master, moments and step are
    untouched, bit for bit.  Otherwise every group's new master and moment
    tensors are made first, and then swapped into the state together with
    the step, so an update that raises part-way leaves the state as it
    was (the supervised loop's retry and emergency checkpoint rely on
    that).  Returns the state."""
    if skip_update:
        return state
    step = state.step + 1
    new = {path: kops.lamb_leaf_update(
        state.master[path], grads[path], state.m[path], state.v[path],
        lr=lr, step=step, b1=b1, b2=b2, eps=eps, wd=wd, impl=impl)
        for path in state.groups.paths}
    state.master, state.m, state.v, state.step = (
        {p: w for p, (w, _, _) in new.items()},
        {p: m for p, (_, m, _) in new.items()},
        {p: v for p, (_, _, v) in new.items()}, step)
    return state
