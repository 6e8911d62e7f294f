"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Plain tensor functions with the reference's names and semantics:

* ``_router``: fp32 logits of the tokens against the router, softmax,
  top-k, the k weights renormalised to sum 1, and the Switch load-balance
  loss E * sum_e f_e * P_e (f_e: the share of the T * k assignments that
  went to expert e; P_e: its mean probability).
* ``moe_dense``: every expert on every token, combined by the router's
  weights in the compute dtype.  The correctness oracle and the serving
  stack's default (``moe_impl="dense"``): it drops nothing, and a token's
  output does not depend on the other tokens of the batch.
* ``_moe_single``: the capacity path, the trainer's default
  (``TrainConfig.moe_impl`` "a2a", as the reference's).  The T * k
  assignments are sorted stably by expert (``_dispatch_indices``); each
  expert takes the first C = max(1, ceil(T * k * capacity_factor / E)) of
  them in token order into an (E, C, d) buffer (``_group_local``), the
  experts run as three batched products (``_expert_ffn``) and the kept
  slots are combined back by their weights (``_combine_local``).  An
  assignment past its expert's C goes to the dump slot E * C and
  contributes 0.  Every token routes and takes capacity, the pad tokens of
  a bucketed prefill among them, so C and the drops depend on the batch as
  the reference's do.
* ``moe_apply``: the entry point.

The reference's mesh paths (``_moe_replicated`` and ``_moe_a2a``, which
shard the experts over a ``model`` axis) wait for the port's sharding
slice.  Without a mesh the reference sends ``a2a`` and ``replicated`` to
the capacity path, and so does the port; ``moe_apply`` refuses a
``model`` axis wider than 1 rather than run another algorithm.

The MoE has no Pallas kernel in the reference (its products are
``jnp.einsum`` outside any kernel), so here the router, the dispatch, the
expert products (``torch.matmul`` / ``torch.bmm``, plain large products)
and the combine are plain PyTorch.

The backward, op by op.  No operation of either path sums with
floating-point atomics on CUDA, so two backwards of one step give the same
bits (``chip_smoke.py --only moe_train`` relaunches one to check):

* the router's products, softmax, renormalisation and ``mean``: fixed-order
  products and reductions;
* ``topk``: its backward scatters the k weights' gradients into zeros at
  the chosen experts, k distinct indices a row (no sum);
* the counts ``f_e`` (``scatter_add_`` of ones): no gradient, as ``f_e``
  has none in the reference; the aux loss reaches the router through
  ``P_e`` alone;
* ``_group_local``: a token's k copies are a broadcast view of it reshaped
  to (T * k, d), whose backward sums the k copies' gradients over the k
  axis, one fixed-order reduction.  (``repeat_interleave`` is an
  ``index_select``, whose backward is an ``index_add_``: atomics, the k
  copies summed in another order each run.)  The ``buf[dest] = ...``
  scatter's backward gathers the buffer's gradient at ``dest``; the only
  duplicate destination is the dump row, which is cut off before the
  experts and so carries a gradient of 0;
* ``_combine_local``: the gather's backward accumulates into the
  processed buffer's gradient, and assignments collide only on the
  appended zero row, whose gradient is cut off; every other row takes
  one term;
* ``_dense_combine``: the ``scatter`` of the top-k weights writes k
  distinct columns a row, and its backward gathers them back; the combine
  is a batched product.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.models.layers import trunc_normal

Params = dict

MOE_IMPLS = ("dense", "a2a", "replicated")


def init_moe(cfg: ModelConfig, generator: torch.Generator, *,
             dtype=torch.float32, device="cpu") -> Params:
    """``router`` (d, E), ``wi`` and ``wg`` (E, d, f), ``wo`` (E, f, d):
    truncated normals of std 0.02, ``wo``'s scaled by 1/sqrt(2 n_layers),
    as the reference's ``init_moe`` (the values differ: ``torch.Generator``
    is not ``jax.random``)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    std_o = 0.02 / math.sqrt(2 * cfg.n_layers)
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {"router": trunc_normal((d, e), **kw),
            "wi": trunc_normal((e, d, f), **kw),
            "wg": trunc_normal((e, d, f), **kw),
            "wo": trunc_normal((e, f, d), stddev=std_o, **kw)}


def _act(cfg: ModelConfig):
    # jax.nn.gelu is the tanh approximation by default
    if cfg.mlp_kind == "swiglu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def _router(params, xt: torch.Tensor, cfg: ModelConfig, policy: Policy):
    """xt: (T, d) -> (probs (T, E) f32, topk_idx (T, k), topk_w (T, k) f32,
    aux 0-d f32)."""
    logits = xt.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.topk(probs, cfg.top_k, dim=-1)
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    e = cfg.n_experts
    # the reference's .at[].add(1.0): counts of whole numbers, exact in fp32
    # in any order (torch.bincount would read its input's max back to the
    # host at every layer)
    flat = topk_idx.reshape(-1)
    f_e = torch.zeros((e,), dtype=torch.float32, device=xt.device)
    f_e = f_e.scatter_add_(0, flat, torch.ones_like(flat, dtype=f_e.dtype))
    f_e = f_e / max(topk_idx.numel(), 1)
    p_e = probs.mean(0)
    aux = e * torch.sum(f_e * p_e)
    return probs, topk_idx, topk_w, aux


def _expert_ffn(wi, wg, wo, x, cfg: ModelConfig, policy: Policy):
    """x: (E, C, d) grouped tokens; weights (E, d, f) / (E, f, d).  Three
    batched products in the compute dtype."""
    cd = policy.compute_dtype
    xc = x.to(cd)
    hi = torch.bmm(xc, wi.to(cd))
    hg = torch.bmm(xc, wg.to(cd))
    return torch.bmm(_act(cfg)(hg) * hi, wo.to(cd))


def _dispatch_indices(topk_idx: torch.Tensor, n_experts: int,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter destinations of the (T * k,) expert assignments.

    Returns (dest (T * k,) int64, keep (T * k,) bool): an assignment's rank
    among its expert's assignments in token order (a stable sort by
    expert) decides it; dest is e * C + rank for a kept one and E * C (the
    dump slot) for a dropped one."""
    tk = topk_idx.reshape(-1)
    sorted_e, order = torch.sort(tk, stable=True)
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=tk.device, dtype=tk.dtype))
    rank = torch.arange(tk.numel(), device=tk.device) - starts[sorted_e]
    keep_sorted = rank < capacity
    dest_sorted = torch.where(keep_sorted, sorted_e * capacity + rank,
                              torch.full_like(rank, n_experts * capacity))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return dest_sorted[inv], keep_sorted[inv]


def _group_local(xt, topk_idx, topk_w, n_experts: int, capacity: int):
    """Group (T, d) tokens into (E, C, d) expert buffers; returns (grouped,
    dest, keep).  Dropped assignments land on the dump row, cut off."""
    t, d = xt.shape
    k = topk_idx.shape[-1]
    dest, keep = _dispatch_indices(topk_idx, n_experts, capacity)
    buf = torch.zeros((n_experts * capacity + 1, d), dtype=xt.dtype,
                      device=xt.device)
    # (T * k, d), a token a slot: a broadcast view, whose backward sums the
    # k copies in one order (the module docstring)
    buf[dest] = xt[:, None].expand(t, k, d).reshape(t * k, d)
    return buf[:-1].reshape(n_experts, capacity, d), dest, keep


def _combine_local(processed, dest, keep, topk_w, t: int, k: int, d: int):
    """The inverse of ``_group_local``: (E, C, d) -> (T, d), each kept slot
    weighted by its router weight in the processed dtype, a dropped slot
    0."""
    flat = processed.reshape(-1, d)
    flat = torch.cat([flat, flat.new_zeros((1, d))], dim=0)
    zero_row = torch.full_like(dest, flat.shape[0] - 1)
    slot_out = flat[torch.where(keep, dest, zero_row)]
    slot_out = slot_out * topk_w.reshape(-1, 1).to(slot_out.dtype)
    return slot_out.reshape(t, k, d).sum(dim=1)


def _dense_experts(params, xt: torch.Tensor, cfg: ModelConfig,
                   policy: Policy) -> torch.Tensor:
    """Every expert on every token: xt (T, d) -> (E, T, d) in the compute
    dtype."""
    cd = policy.compute_dtype
    xc = xt.to(cd)
    hi = torch.matmul(xc, params["wi"].to(cd))                 # (E, T, f)
    hg = torch.matmul(xc, params["wg"].to(cd))
    return torch.bmm(_act(cfg)(hg) * hi, params["wo"].to(cd))


def _dense_combine(out_e, topk_idx, topk_w) -> torch.Tensor:
    """(E, T, d) expert outputs -> (T, d): each token's top-k outputs
    weighted by the router, in the outputs' dtype; the other experts'
    weights are 0."""
    w = torch.zeros((topk_idx.shape[0], out_e.shape[0]), dtype=out_e.dtype,
                    device=out_e.device).scatter(
                        1, topk_idx, topk_w.to(out_e.dtype))
    return torch.einsum("etd,te->td", out_e, w)


def moe_dense(params, x: torch.Tensor, cfg: ModelConfig, policy: Policy):
    """The oracle: every expert on every token, no drops.  x: (B, S, d).
    Returns (y (B, S, d) in the compute dtype, aux)."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    _, topk_idx, topk_w, aux = _router(params, xt, cfg, policy)
    out = _dense_combine(_dense_experts(params, xt, cfg, policy), topk_idx,
                         topk_w)
    return out.reshape(b, s, d), aux


def _moe_single(params, xt: torch.Tensor, cfg: ModelConfig, policy: Policy,
                capacity_factor: float):
    """The capacity path on one device: xt (T, d) -> (y (T, d), aux)."""
    t, d = xt.shape
    c = max(1, -(-int(t * cfg.top_k * capacity_factor) // cfg.n_experts))
    _, topk_idx, topk_w, aux = _router(params, xt, cfg, policy)
    grouped, dest, keep = _group_local(xt, topk_idx, topk_w, cfg.n_experts,
                                       c)
    processed = _expert_ffn(params["wi"], params["wg"], params["wo"],
                            grouped, cfg, policy)
    return _combine_local(processed, dest, keep, topk_w, t, cfg.top_k,
                          d), aux


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, policy: Policy, *,
              impl: str = "a2a", capacity_factor: Optional[float] = None,
              model_axis: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN entry point.  x: (B, S, d).  Returns (y, aux).

    ``impl``: ``"dense"`` (``moe_dense``), or ``"a2a"`` / ``"replicated"``,
    which on one device are the capacity path (``_moe_single``) at
    ``capacity_factor`` (default ``cfg.capacity_factor``), as in the
    reference without a mesh.  ``model_axis`` is the size of the mesh axis
    the experts would be sharded over: anything but 1 raises
    ``NotImplementedError`` (the mesh paths come with the sharding slice),
    and an unknown ``impl`` raises ``ValueError``."""
    if impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe impl {impl!r} (one of {MOE_IMPLS})")
    if model_axis != 1:
        raise NotImplementedError(
            f"expert parallelism over a 'model' axis of {model_axis}: the "
            "reference's _moe_replicated and _moe_a2a come with the port's "
            "sharding slice")
    capacity_factor = capacity_factor or cfg.capacity_factor
    if impl == "dense":
        return moe_dense(params, x, cfg, policy)
    b, s, d = x.shape
    out, aux = _moe_single(params, x.reshape(-1, d), cfg, policy,
                           capacity_factor)
    return out.reshape(b, s, d), aux
