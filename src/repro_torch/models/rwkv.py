"""RWKV-6 "Finch" time mix and channel mix (port of
``repro/models/rwkv.py``): attention-free, with a data-dependent decay.

[arXiv:2404.05892]  The WKV6 recurrence per head (head size hs)::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: hs x hs state)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with a per-channel, per-token decay w_t = exp(-exp(decay(x_t))) in (0, 1).

An unmasked prefill runs the chunk-parallel form through ``kops.wkv6``:
the hand-written kernel for a CUDA tensor, ``kernels.ref.wkv6_ref`` (the
reference's ``wkv6_chunked``) for a CPU tensor.  A decode step (S = 1) and
a masked prefill (``valid_len`` given, as the slot prefill always passes)
run ``wkv6_sequential``, the reference's step-by-step oracle: pad steps are
the exact identity (w = 1, k = 0), so the carried state does not depend on
the bucket width.  The dispatch is the reference's: S == 1 or
``valid_len`` -> sequential; otherwise the chunked form, which raises for
an S > 64 that is not a multiple of 64 (the reference asserts there).
The recurrence runs in fp32 (the paper's §4.2 "numerically unsafe op").

The decode state of a layer is ``{"tm_shift": (B, 1, d), "wkv": (B, H, hs,
hs), "cm_shift": (B, 1, d)}``, all fp32.  The mixers return new state
tensors; ``transformer`` copies them into the live state in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import trunc_normal, valid_token_mask

LORA = 32      # low-rank size of the data-dependent mix projections
N_MIX = 5      # the mixes, in the order of maa_wkvrg's rows: w, k, v, r, g
GN_EPS = 64e-5


def init_time_mix(cfg: ModelConfig, generator: torch.Generator, *,
                  dtype=torch.float32, device="cpu") -> dict:
    """The reference's ``init_time_mix`` distributions (values differ:
    ``torch.Generator`` is not ``jax.random``)."""
    d = cfg.d_model
    h, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
    kw = dict(generator=generator, dtype=dtype, device=device)
    full = lambda shape, val: torch.full(shape, val, dtype=dtype,
                                         device=device)
    return {
        "maa_x": full((d,), 0.0),
        "maa_wkvrg": full((N_MIX, d), 0.0),
        "maa_w1": trunc_normal((d, N_MIX * LORA), stddev=1e-4, **kw),
        "maa_w2": trunc_normal((N_MIX, LORA, d), stddev=1e-4, **kw),
        "decay": full((d,), -6.0),
        "decay_w1": trunc_normal((d, 64), stddev=1e-4, **kw),
        "decay_w2": trunc_normal((64, d), stddev=1e-4, **kw),
        "u": trunc_normal((h, hs), stddev=0.5, **kw),
        "wr": trunc_normal((d, d), **kw),
        "wk": trunc_normal((d, d), **kw),
        "wv": trunc_normal((d, d), **kw),
        "wg": trunc_normal((d, d), **kw),
        "wo": trunc_normal((d, d), stddev=0.02 / math.sqrt(2 * cfg.n_layers),
                           **kw),
        "ln_x_scale": full((d,), 1.0),
        "ln_x_bias": full((d,), 0.0),
    }


def init_channel_mix(cfg: ModelConfig, generator: torch.Generator, *,
                     dtype=torch.float32, device="cpu") -> dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {
        "maa_k": torch.zeros((d,), dtype=dtype, device=device),
        "maa_r": torch.zeros((d,), dtype=dtype, device=device),
        "wk": trunc_normal((d, f), **kw),
        "wr": trunc_normal((d, d), **kw),
        "wv": trunc_normal((f, d), stddev=0.02 / math.sqrt(2 * cfg.n_layers),
                           **kw),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    h, hs, d = cfg.rwkv_n_heads, cfg.rwkv_head_size, cfg.d_model
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"tm_shift": z(batch, 1, d), "wkv": z(batch, h, hs, hs),
            "cm_shift": z(batch, 1, d)}


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor],
                 valid_len=None):
    """Returns (x_{t-1}, new_last).  last: (B, 1, d) from the previous step.

    With right-padded rows (``valid_len``, scalar or (B,)) the carried
    shift is the last real token: position t of ``x`` sits at index t + 1
    of ``ext = [last, x]``, so it is ``ext[valid_len]`` (``valid_len`` 0
    gives ``last`` itself, as a zero-token scan would).
    """
    if last is None:
        last = torch.zeros_like(x[:, :1])
    ext = torch.cat([last.to(x.dtype), x], dim=1)
    shifted = ext[:, :-1]
    if valid_len is None:
        return shifted, x[:, -1:]
    b = x.shape[0]
    vl = torch.as_tensor(valid_len, device=x.device).long().reshape(-1)
    vl = vl.expand(b)
    return shifted, ext[torch.arange(b, device=x.device), vl][:, None]


def wkv6_sequential(r, k, v, logw, u, s0):
    """Step-by-step WKV6 (the reference's oracle, and its decode and
    masked-prefill path).  r, k, v, logw: (B, S, H, hs); u: (H, hs); s0:
    (B, H, hs, hs).  Returns (o (B, S, H, hs), s_final), fp32."""
    f32 = torch.float32
    r, k, v, logw = (t.to(f32) for t in (r, k, v, logw))
    uf = u.to(f32)[None, :, :, None]
    s = s0.to(f32)
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,hs,hs)
        outs.append(torch.einsum("bhc,bhcv->bhv", r[:, t], s + uf * kv))
        s = torch.exp(logw[:, t])[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def apply_time_mix(params: dict, x: torch.Tensor, cfg: ModelConfig,
                   policy: Policy, *, state: Optional[dict] = None,
                   return_state: bool = False, valid_len=None,
                   impl: Optional[str] = None):
    """The time mix of one layer.  x: (B, S, d).  Returns (y (B, S, d) in
    the compute dtype, {"tm_shift", "wkv"} or None).

    ``valid_len`` (scalar or (B,)): right-padded prefill.  Pad positions
    step the recurrence with the identity (logw = 0 -> w = 1, k = 0) and
    the carried shift is gathered at the true last token, so the state
    after a padded scan is bit-identical to an unpadded one.
    """
    b, s, d = x.shape
    h, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
    cd, f32 = policy.compute_dtype, torch.float32
    xc = x.to(cd)
    if s == 1:
        valid_len = None

    prev = state["tm_shift"] if state is not None else None
    shifted, new_shift = _token_shift(xc, prev, valid_len=valid_len)
    xx = shifted - xc
    # ddlerp: data-dependent interpolation weights through a LoRA
    xxx = xc + xx * params["maa_x"].to(cd)
    lora = torch.tanh(xxx @ params["maa_w1"].to(cd))
    lora = lora.reshape(b, s, N_MIX, LORA).permute(2, 0, 1, 3)
    deltas = torch.einsum("nbsl,nld->nbsd", lora, params["maa_w2"].to(cd))
    mix = params["maa_wkvrg"].to(cd)[:, None, None] + deltas   # (5,B,S,d)
    xw, xk, xv, xr, xg = (xc + xx * mix[i] for i in range(N_MIX))

    r = (xr @ params["wr"].to(cd)).reshape(b, s, h, hs)
    k = (xk @ params["wk"].to(cd)).reshape(b, s, h, hs)
    v = (xv @ params["wv"].to(cd)).reshape(b, s, h, hs)
    g = xg @ params["wg"].to(cd)

    # data-dependent decay in fp32: logw = -exp(decay + lora(xw)) <= 0
    dd = torch.tanh(xw.to(f32) @ params["decay_w1"].to(f32))
    dd = dd @ params["decay_w2"].to(f32)
    logw = -torch.exp(params["decay"].to(f32)[None, None] + dd)
    logw = logw.reshape(b, s, h, hs)

    if valid_len is not None:
        # pad positions: w = 1 (no decay), k = 0 (no update); r and v need
        # no mask, the caller discards pad outputs
        keep = valid_token_mask(valid_len, b, s, x.device)[..., None, None]
        k = torch.where(keep, k, torch.zeros((), dtype=k.dtype,
                                             device=k.device))
        logw = torch.where(keep, logw, torch.zeros((), dtype=f32,
                                                   device=x.device))

    s0 = state["wkv"] if state is not None else \
        torch.zeros((b, h, hs, hs), dtype=f32, device=x.device)
    if s == 1 or valid_len is not None:
        o, s_final = wkv6_sequential(r, k, v, logw, params["u"], s0)
    else:
        o, s_final = kops.wkv6(r, k, v, logw, params["u"], s0, impl=impl)

    # per-head group norm (variance without Bessel's correction, as
    # jnp.var), then the gate
    of = o.reshape(b, s, h, hs)
    mean = of.mean(-1, keepdim=True)
    var = torch.square(of - mean).mean(-1, keepdim=True)
    of = (of - mean) * torch.rsqrt(var + GN_EPS)
    of = of.reshape(b, s, d) * params["ln_x_scale"].to(f32) + \
        params["ln_x_bias"].to(f32)
    y = (of.to(cd) * F.silu(g)) @ params["wo"].to(cd)

    new_state = None
    if return_state:
        new_state = {"tm_shift": new_shift.to(f32), "wkv": s_final}
    return y, new_state


def apply_channel_mix(params: dict, x: torch.Tensor, cfg: ModelConfig,
                      policy: Policy, *, state: Optional[dict] = None,
                      return_state: bool = False, valid_len=None):
    """The channel mix: sigmoid(x_r wr) * (relu(x_k wk)^2 wv).  Returns
    (y, {"cm_shift"} or None)."""
    cd = policy.compute_dtype
    xc = x.to(cd)
    if x.shape[1] == 1:
        valid_len = None
    prev = state["cm_shift"] if state is not None else None
    shifted, new_shift = _token_shift(xc, prev, valid_len=valid_len)
    xx = shifted - xc
    xk = xc + xx * params["maa_k"].to(cd)
    xr = xc + xx * params["maa_r"].to(cd)
    kk = torch.square(torch.relu(xk @ params["wk"].to(cd)))
    y = torch.sigmoid(xr @ params["wr"].to(cd)) * (kk @ params["wv"].to(cd))
    new_state = ({"cm_shift": new_shift.to(torch.float32)}
                 if return_state else None)
    return y, new_state
