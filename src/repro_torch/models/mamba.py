"""Mamba (S6) selective state-space mixer, as Jamba's hybrid blocks use it
(port of ``repro/models/mamba.py``).

Per channel c of d_inner and state index n of N, with dt_t = softplus(
x_t W_dt + dt_bias) and A = -exp(a_log)::

    h_t[c, n] = exp(dt_t[c] A[c, n]) h_{t-1}[c, n] + dt_t[c] x_t[c] B_t[n]
    y_t[c]    = sum_n h_t[c, n] C_t[n] + D[c] x_t[c]

after an in-projection to (x, z), a depthwise causal conv of width d_conv
and SiLU on x; the output is y * SiLU(z) projected back to d_model.

The reference's selective scan is ``jnp`` (``lax.associative_scan``
within chunks under ``lax.scan``), no Pallas kernel, so the port's is
plain PyTorch:

* ``_ssm_chunked``: chunks of ``chunk`` steps, a doubling (Hillis-Steele)
  scan within each chunk -- log2(chunk) rounds of the reference's combine
  (a_l a_r, b_l a_r + b_r) -- and the state carried across chunks.  The
  unmasked prefill and the full forward run it.  An S that is not a
  multiple of ``min(chunk, S)`` raises, as the reference asserts.
* ``_ssm_sequential``: h = a h + bx step by step.  A decode step (S = 1)
  and a masked prefill (``valid_len``, as every slot prefill passes) run
  it: pad steps are the fp32 identity (a = 1, bx = 0), exact no-ops, so
  the state after a right-padded prefill is bit-identical to that of an
  unpadded prefill of the true prompt, whatever the bucket width.

Memory.  The reference materialises the (B, S, d_inner, N) fp32
coefficients (``a_coef``, ``bx``, their masked copies and the states
``ys``): 1 GiB each per batch row at jamba's d_inner 16384, N 16 and S
1024.  ``apply_mamba`` forms them a block of steps at a time instead --
``chunk`` steps on the chunked path, ``SEQ_BLOCK`` on the sequential one
-- from that block's dt, x and B, runs the scan over the block from the
carried state and contracts the block's states with its C.  These are the
reference's elementwise operations, so the padded and the unpadded prefill
still agree bit for bit; a block holds (B, block, d_inner, N) fp32 (64 MiB
a batch row at full width).

The projections run in the policy's compute dtype, the recurrence in fp32
(the paper's §4.2 "numerically unsafe" category); ``a_log`` and
``dt_bias`` reach ``exp``/``softplus`` in fp32.  The decode state of a
layer is ``{"conv": (B, d_conv - 1, d_inner), "ssm": (B, d_inner, N)}``,
both fp32; ``apply_mamba`` returns new tensors and ``transformer`` copies
them into the live state in place.

``_in_proj``, ``_causal_conv``, ``_selective_scan`` and ``_out_proj``
are looked up at call time, so ``launch/profile_serve.py`` can span each.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.models.layers import trunc_normal, valid_token_mask

SEQ_BLOCK = 64     # steps a block on the sequential path


def init_mamba(cfg: ModelConfig, generator: torch.Generator, *,
               dtype=torch.float32, device="cpu") -> dict:
    """The reference's ``init_mamba`` distributions (values differ:
    ``torch.Generator`` is not ``jax.random``): S4D-real ``a_log`` =
    log(1..N) on every channel, ``dt_bias`` the inverse softplus of a
    log-uniform dt in [1e-3, 1e-1], ``out_proj`` at std 0.02 / sqrt(2
    n_layers)."""
    d, din = cfg.d_model, cfg.mamba_d_inner
    n, r, dc = cfg.mamba_d_state, cfg.dt_rank, cfg.mamba_d_conv
    kw = dict(generator=generator, dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.arange(1, n + 1, **f32))[None].expand(din, n)
    u = torch.rand((din,), generator=generator, **f32)
    dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))        # inverse softplus
    return {
        "in_proj": trunc_normal((d, 2 * din), **kw),
        "conv_w": trunc_normal((dc, din), stddev=0.1, **kw),
        "conv_b": torch.zeros((din,), dtype=dtype, device=device),
        "x_proj": trunc_normal((din, r + 2 * n), **kw),
        "dt_proj": trunc_normal((r, din), stddev=r ** -0.5, **kw),
        "dt_bias": dt_bias.to(dtype),
        "a_log": a_log.contiguous().to(dtype),
        "d_skip": torch.ones((din,), dtype=dtype, device=device),
        "out_proj": trunc_normal(
            (din, d), stddev=0.02 / math.sqrt(2 * cfg.n_layers), **kw),
    }


def init_mamba_state(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    din, n, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"conv": z(batch, dc - 1, din), "ssm": z(batch, din, n)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None, valid_len=None):
    """Depthwise causal conv along time.  x: (B, S, din); w: (dc, din).
    Returns (y, new_state), the state the last dc - 1 inputs.

    ``valid_len`` (scalar or (B,)): true lengths of right-padded rows; the
    carried window then ends at each row's true length.  Position t of
    ``x`` sits at index t + dc - 1 of ``x_pad`` (dc - 1 context rows are
    prepended), so the window over [len - dc + 1, len) is indices [len,
    len + dc - 2]: for a row shorter than dc - 1 the gather reaches back
    into the prepended context (the previous state, or zeros), as an
    unpadded run would carry it."""
    dc = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, dc - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(x_pad[:, k:k + s] * w[k][None, None] for k in range(dc))
    if dc <= 1:
        new_state = None
    elif valid_len is None:
        new_state = x_pad[:, x_pad.shape[1] - (dc - 1):]
    else:
        bsz = x.shape[0]
        vl = torch.as_tensor(valid_len, device=x.device).long().reshape(-1)
        idx = vl.expand(bsz)[:, None] + torch.arange(dc - 1, device=x.device)
        new_state = x_pad[torch.arange(bsz, device=x.device)[:, None], idx]
    return y + b[None, None], new_state


def _scan_chunk(a: torch.Tensor, bx: torch.Tensor, h: torch.Tensor):
    """One chunk of h_t = a_t h_{t-1} + bx_t from h.  a, bx: (B, L, din,
    N); h: (B, din, N).  A doubling scan: after the round at offset o,
    step t holds the combine of steps (t - 2o, t]."""
    off, n = 1, a.shape[1]
    while off < n:
        a_r, bx_r = a[:, off:], bx[:, off:]
        bx = torch.cat([bx[:, :off], bx[:, :-off] * a_r + bx_r], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a_r], dim=1)
        off *= 2
    ys = a * h[:, None] + bx
    return ys, ys[:, -1]


def _ssm_chunked(a_coef: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor,
                 chunk: int):
    """h_t = a_t h_{t-1} + bx_t by chunks of ``chunk`` steps, a doubling
    scan within each.  a_coef, bx: (B, S, din, N) fp32; h0: (B, din, N).
    Returns (ys (B, S, din, N), h_final)."""
    s = a_coef.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{chunk}")
    ys, h = [], h0
    for i in range(0, s, chunk):
        y, h = _scan_chunk(a_coef[:, i:i + chunk], bx[:, i:i + chunk], h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _ssm_sequential(a_coef: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """The plain scan, step by step (the reference's oracle, and its decode
    and masked-prefill path).  Returns (ys (B, S, din, N), h_final)."""
    h, ys = h0, []
    for t in range(a_coef.shape[1]):
        h = a_coef[:, t] * h + bx[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h


def _scan_blocks(dt, dx, b_in, c_in, a, h0, step: int, *,
                 sequential: bool = False, keep=None, starts=None):
    """The scan a block of ``step`` steps at a time: each block's
    coefficients a = exp(dt A) and bx = dx B (pad steps of ``keep`` (B, S)
    the identity, a = 1 and bx = 0), its scan from the carried state --
    step by step with ``sequential``, else one chunk of the doubling scan
    -- and the contraction of its states with C.  Returns (y (B, S, din),
    h_final); ``starts`` (a list) collects the state at each block's
    start."""
    h, ys = h0, []
    for i in range(0, dt.shape[1], step):
        blk = slice(i, i + step)
        if starts is not None:
            starts.append(h)
        a_coef = torch.exp(dt[:, blk, :, None] * a)           # (B,L,din,N)
        bx = dx[:, blk, :, None] * b_in[:, blk, None, :]
        if keep is not None:
            k = keep[:, blk, None, None]
            a_coef = torch.where(k, a_coef, torch.ones((), dtype=a.dtype,
                                                       device=a.device))
            bx = torch.where(k, bx, torch.zeros((), dtype=a.dtype,
                                                device=a.device))
        if sequential:
            hs, h = _ssm_sequential(a_coef, bx, h)
        else:
            hs, h = _ssm_chunked(a_coef, bx, h, step)
        ys.append(torch.einsum("bldn,bln->bld", hs, c_in[:, blk]))
        del a_coef, bx, hs
    return torch.cat(ys, dim=1), h


class _SelectiveScan(torch.autograd.Function):
    """The chunked selective scan with a hand-written backward, which
    recomputes a chunk's states from its saved start state.

    Inputs: dt (B, S, din) after softplus, x1 (B, S, din), B and C (B, S,
    N), A = -exp(a_log) (din, N) and h0 (B, din, N), all fp32, and the
    chunk.  Outputs: y_t = sum_n h_t C_t (B, S, din), without the D skip,
    and h_final.  The forward is ``_scan_blocks`` (the serving path's
    bits) and keeps only its inputs and the state at each chunk's start,
    (B, S / chunk, din, N): autograd through the doubling scan would keep
    every round's (B, chunk, din, N) tensors, ~57 GiB for one of jamba's
    layers at a micro-batch of 4 x 1024.

    The backward walks the chunks from last to first.  It recomputes the
    chunk's a, bx and states, then runs the reverse recurrence
    g_t = C_t dy_t + a_{t+1} g_{t+1} -- g_t the gradient of h_t -- as a
    doubling scan over the reversed chunk from the gradient carried in
    from the chunk after it (a_{t+1} g_{t+1} of that chunk's first step,
    or the gradient of h_final).  Then dC_t = sum_d h_t dy_t, d(a_t) =
    g_t h_{t-1} (h_{t-1} of the chunk's first step the saved start
    state), d(bx_t) = g_t, and through a = exp(dt A) and bx = dt x1 B the
    gradients of dt, x1, B and A; dh0 is a_0 g_0.  Everything is
    elementwise or a reduction in a fixed order: dA is summed over (B, L)
    within a chunk and added chunk by chunk in fp32, and no operation
    adds with atomics, so two backward passes give the same bits.  A
    chunk's recompute holds a, bx, its states, g and their products, each
    (B, chunk, din, N) fp32, and frees them before the next."""

    @staticmethod
    def forward(ctx, dt, x1, b_in, c_in, a, h0, chunk):
        starts = []
        y, h = _scan_blocks(dt, dt * x1, b_in, c_in, a, h0, chunk,
                            starts=starts)
        ctx.chunk = chunk
        ctx.save_for_backward(dt, x1, b_in, c_in, a, torch.stack(starts, 1))
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        dt, x1, b_in, c_in, a, starts = ctx.saved_tensors
        step = ctx.chunk
        dx = dt * x1
        ddt, dx1 = torch.empty_like(dt), torch.empty_like(x1)
        db, dc = torch.empty_like(b_in), torch.empty_like(c_in)
        da = torch.zeros_like(a)
        g = dh      # autograd passes zeros for an output that was not used
        one = torch.ones((), dtype=a.dtype, device=a.device)
        for i in reversed(range(starts.shape[1])):
            blk = slice(i * step, (i + 1) * step)
            dt_b, dx_b, dy_b = dt[:, blk], dx[:, blk], dy[:, blk]
            a_coef = torch.exp(dt_b[..., None] * a)          # (B,L,din,N)
            bx = dx_b[..., None] * b_in[:, blk, None, :]
            hs, _ = _scan_chunk(a_coef, bx, starts[:, i])
            del bx
            dc[:, blk] = torch.einsum("bldn,bld->bln", hs, dy_b)
            # the reverse recurrence over the flipped chunk: step j is
            # t = L - 1 - j, its multiplier a_{t+1} (1 at j = 0, where the
            # carried gradient already holds it)
            e = torch.flip(dy_b[..., None] * c_in[:, blk, None, :], (1,))
            a_rev = torch.cat([one.expand_as(a_coef[:, :1]),
                               torch.flip(a_coef[:, 1:], (1,))], dim=1)
            gs, _ = _scan_chunk(a_rev, e, g)
            del e, a_rev
            gs = torch.flip(gs, (1,))                         # g_t
            g = a_coef[:, 0] * gs[:, 0]
            h_prev = torch.cat([starts[:, i, None], hs[:, :-1]], dim=1)
            del hs
            # d(dt A) = g h_{t-1} a
            dlog = gs * h_prev * a_coef
            del h_prev, a_coef
            da += torch.einsum("bldn,bld->dn", dlog, dt_b)
            ddx = torch.einsum("bldn,bln->bld", gs, b_in[:, blk])
            db[:, blk] = torch.einsum("bldn,bld->bln", gs, dx_b)
            del gs
            ddt[:, blk] = torch.einsum("bldn,dn->bld", dlog, a) + \
                ddx * x1[:, blk]
            dx1[:, blk] = ddx * dt_b
            del dlog, ddx
        return ddt, dx1, db, dc, da, g, None


def _in_proj(params: dict, x: torch.Tensor, cd):
    """(x1, z), each (B, S, din), in the compute dtype."""
    xz = x.to(cd) @ params["in_proj"].to(cd)
    return xz.chunk(2, dim=-1)


def _selective_scan(params: dict, x1: torch.Tensor, cfg: ModelConfig, cd,
                    h0: torch.Tensor, *, keep=None, sequential: bool = False,
                    chunk: int = 128):
    """From the conv's SiLU output x1 (B, S, din) and the state h0: y =
    C h + D x1 (B, S, din) in fp32 and the final state.  ``keep`` (B, S)
    masks pad steps to the identity; ``sequential`` picks the step-by-step
    scan, else chunks of ``chunk``, through ``_SelectiveScan`` under grad
    (training) and ``_scan_blocks`` without (serving: the same bits)."""
    b, s, _ = x1.shape
    n, r = cfg.mamba_d_state, cfg.dt_rank
    f32 = torch.float32
    dbc = x1 @ params["x_proj"].to(cd)
    dt, b_in, c_in = torch.split(dbc, [r, n, n], dim=-1)
    dt = dt @ params["dt_proj"].to(cd) + params["dt_bias"].to(cd)
    dt = F.softplus(dt.to(f32))                               # (B,S,din)
    a = -torch.exp(params["a_log"].to(f32))                   # (din,N)
    dx = dt * x1.to(f32)
    b_in, c_in = b_in.to(f32), c_in.to(f32)
    if s == 1:
        # decode: one step, no scan machinery
        h = torch.exp(dt[:, 0, :, None] * a) * h0 + \
            dx[:, 0, :, None] * b_in[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", h, c_in[:, 0])[:, None]
    else:
        step = SEQ_BLOCK if sequential else min(chunk, s)
        if not sequential and s % step:
            raise ValueError(f"sequence {s} is not a multiple of the chunk "
                             f"{step}")
        if not sequential and keep is None and torch.is_grad_enabled():
            y, h = _SelectiveScan.apply(dt, x1.to(f32), b_in, c_in, a, h0,
                                        step)
        else:
            y, h = _scan_blocks(dt, dx, b_in, c_in, a, h0, step,
                                sequential=sequential, keep=keep)
    y = y + params["d_skip"].to(f32) * x1.to(f32)
    return y, h


def _out_proj(params: dict, y: torch.Tensor, z: torch.Tensor, cd):
    return (y.to(cd) * F.silu(z)) @ params["out_proj"].to(cd)


def apply_mamba(params: dict, x: torch.Tensor, cfg: ModelConfig,
                policy: Policy, *, state: Optional[dict] = None,
                return_state: bool = False, chunk: int = 128,
                use_chunked: bool = True, valid_len=None):
    """x: (B, S, d).  Returns (y (B, S, d) in the compute dtype, {"conv",
    "ssm"} or None).

    ``valid_len`` (scalar or (B,)), for S > 1: right-padded prefill.  Pad
    positions step the recurrence with the fp32 identity (a = 1, bx = 0)
    and the scan runs sequentially, so the carried state is bit-identical
    to that of an unpadded prefill of the true prompt."""
    s = x.shape[1]
    cd = policy.compute_dtype
    if s == 1:
        valid_len = None
    x1, z = _in_proj(params, x, cd)
    conv_state = state["conv"] if state is not None else None
    x1, new_conv = _causal_conv(x1, params["conv_w"].to(cd),
                                params["conv_b"].to(cd), conv_state,
                                valid_len=valid_len)
    x1 = F.silu(x1)
    h0 = state["ssm"] if state is not None else torch.zeros(
        (x.shape[0], cfg.mamba_d_inner, cfg.mamba_d_state),
        dtype=torch.float32, device=x.device)
    keep = valid_token_mask(valid_len, x.shape[0], s, x.device)
    y, h = _selective_scan(params, x1, cfg, cd, h0, keep=keep,
                           sequential=keep is not None or not use_chunked,
                           chunk=chunk)
    out = _out_proj(params, y, z, cd)
    if not return_state:
        return out, None
    return out, {"conv": new_conv.to(torch.float32) if new_conv is not None
                 else state["conv"], "ssm": h}
