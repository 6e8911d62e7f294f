"""Kernel dispatch by device (port of ``repro/kernels/ops.py``).

A CUDA tensor goes to the hand-written kernel, and the call raises if the
kernel cannot take it; a CPU tensor goes to the plain PyTorch version in
``kernels/ref.py``.  There is no environment switch and no fallback on
error.  ``impl="torch"`` runs the plain version on any device: it exists for
the tests and ``chip_smoke.py``, which hold the kernels against it on the
card.

Two layers:

* one dispatcher per kernel (``flash_attention``, ``flash_attention_bwd``,
  ``layernorm_fwd``, ``layernorm_bwd``, ``bias_gelu_fwd``,
  ``bias_gelu_bwd``, ``lamb_moments``, ``paged_decode_attention``,
  ``wkv6``): kernel or plain version, nothing else.
* the differentiable ops the models call (``flash_attention_vjp``,
  ``layernorm``, ``bias_gelu``) and the optimizer's ``lamb_leaf_update``.
  They call the dispatchers by name at call time, forward and backward,
  so a wrapper set on this module in their place (``chip_smoke.py`` does,
  to hold every call against the plain version) sees every launch.  The
  flash backward is a kernel, as on the TPU.  The JAX package has no
  LayerNorm or bias-GELU backward kernel (XLA differentiates and fuses the
  forward); the port's are hand-written kernels too, from the saved inputs
  and statistics.  Every backward kernel gives the same bits from run to
  run.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.profiler import record_function

from repro_torch.kernels import bias_gelu as _bg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lamb_update as _lu
from repro_torch.kernels import layernorm as _ln
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import wkv6 as _wkv

def _use_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    if impl == "torch":
        return False
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}: pass None (by device) or "
                         "'torch' (plain version)")
    return x.is_cuda


# ---------------------------------------------------------------------------
# one dispatcher per kernel
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, impl: Optional[str] = None,
                    out: Optional[torch.Tensor] = None):
    """q: (B, H, S, Dh); k, v: (B, KV, S, Dh).  Returns (out, lse).  GQA is
    read by head index in both versions; K and V are not repeated."""
    if _use_kernel(q, impl):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, out=out)
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    if out is not None:
        out.copy_(o)
        o = out
    return o, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        impl: Optional[str] = None):
    """FlashAttention-2 backward.  q, out, dout: (B, H, Sq, Dh); k, v:
    (B, H, Skv, Dh) (the kernels take equal head counts); lse (B, H, Sq)
    from the forward.  Returns (dq, dk, dv)."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    if _use_kernel(q, impl):
        return _fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)


def layernorm_fwd(x, scale, bias, *, eps: float = 1e-6,
                  impl: Optional[str] = None):
    """Row LayerNorm.  Returns (y in x's dtype, mean, rstd) with the
    statistics (rows,) float32."""
    if _use_kernel(x, impl):
        return _ln.layernorm(x, scale, bias, eps=eps)
    return ref.layernorm_ref(x, scale, bias, eps)


def layernorm_bwd(dy, x, scale, mean, rstd, *, impl: Optional[str] = None):
    """LayerNorm's gradient from the saved mean and rstd.  Returns (dx in
    x's dtype, dscale, dbias in scale's dtype)."""
    if _use_kernel(x, impl):
        return _ln.layernorm_bwd(dy, x, scale, mean, rstd)
    return ref.layernorm_bwd_ref(dy, x, scale, mean, rstd)


def bias_gelu_fwd(x, b, *, impl: Optional[str] = None):
    """GELU-tanh(x + b) in fp32, rounded once to x's dtype."""
    if _use_kernel(x, impl):
        return _bg.bias_gelu(x, b)
    return ref.bias_gelu_ref(x, b)


def bias_gelu_bwd(dy, x, b, *, impl: Optional[str] = None):
    """The gradient of GELU-tanh(x + b), in fp32 rounded once.  Returns
    (dx in x's dtype, db in b's dtype)."""
    if _use_kernel(x, impl):
        return _bg.bias_gelu_bwd(dy, x, b)
    return ref.bias_gelu_bwd_ref(dy, x, b)


def lamb_moments(w, g, m, v, *, step: int, b1=0.9, b2=0.999, eps=1e-6,
                 wd=0.01, impl: Optional[str] = None):
    """LAMB m', v' and the bias-corrected update direction, fp32."""
    kw = dict(b1=b1, b2=b2, eps=eps, wd=wd, step=step)
    if _use_kernel(w, impl):
        return _lu.lamb_moments(w, g, m, v, **kw)
    return ref.lamb_moments_ref(w, g, m, v, **kw)


def paged_decode_attention(q, k_pages, v_pages, block_table, kv_len, *,
                           k_scale=None, v_scale=None, softcap: float = 0.0,
                           impl: Optional[str] = None):
    """q: (B, H, Dh); pages: (P, page_size, KV, Dh); block_table:
    (B, max_pages) int32; kv_len: (B,) int32; ``k_scale``/``v_scale``
    (P, KV) mark int8 pages.  Returns (B, H, Dh)."""
    if _use_kernel(q, impl):
        return _pa.paged_decode_attention(
            q, k_pages, v_pages, block_table, kv_len, k_scale=k_scale,
            v_scale=v_scale, softcap=softcap)
    return ref.paged_decode_attention_ref(
        q, k_pages, v_pages, block_table, kv_len, k_scale=k_scale,
        v_scale=v_scale, softcap=softcap)


def wkv6(r, k, v, logw, u, s0, *, chunk: int = 64,
         impl: Optional[str] = None):
    """RWKV-6 chunk recurrence.  r, k, v, logw: (B, S, H, hs); u: (H, hs);
    s0: (B, H, hs, hs); ``min(chunk, S)`` must divide S.  Returns (o
    (B, S, H, hs), s_final (B, H, hs, hs)), both float32.  Inference only:
    the JAX package has no backward for it either."""
    if _use_kernel(r, impl):
        return _wkv.wkv6(r, k, v, logw, u, s0, chunk=chunk)
    return ref.wkv6_ref(r, k, v, logw, u, s0, chunk=chunk)


# ---------------------------------------------------------------------------
# differentiable ops
# ---------------------------------------------------------------------------

def _rows16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the row kernels read it (a
    copy only where it is not)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _FlashAttention(torch.autograd.Function):
    """The flash forward paired with the flash backward kernels, as
    ``_flash_vjp`` pairs them in the reference (``repro/kernels/ops.py``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, impl):
        kw = dict(causal=causal, window=window, softcap=softcap, impl=impl)
        b, h, s, dh = q.shape
        # the output in the model's (B, S, H, Dh) layout, seen as (B, H, S, Dh)
        out = torch.empty((b, s, h, dh), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        out, lse = flash_attention(q, k, v, out=out, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1 or dout.data_ptr() % 16 or any(
                st % 8 for st in dout.stride()[:3]):
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_vjp(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, impl: Optional[str] = None):
    """Differentiable attention (out only).  q, k, v: (B, H, S, Dh) of any
    strides with a contiguous head dim; out comes back as a (B, H, S, Dh)
    view of a (B, S, H, Dh) tensor."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 float(softcap), impl)


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps, impl):
        y, mean, rstd = layernorm_fwd(x, scale, bias, eps=eps,
                                            impl=impl)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.impl = impl
        return y

    @staticmethod
    def backward(ctx, dy):
        # under non-reentrant checkpoint the first unpack of a saved tensor
        # recomputes the whole block: the span below holds the backward
        # alone, so a profile splits the two (launch/profile_train.py)
        x, scale, mean, rstd = ctx.saved_tensors
        with record_function(LAYERNORM_BWD_SPAN):
            dx, dscale, dbias = layernorm_bwd(_rows16(dy), x, scale, mean,
                                              rstd, impl=ctx.impl)
        return dx, dscale, dbias, None, None


# the profiler span around the LayerNorm backward's own work
LAYERNORM_BWD_SPAN = "repro_torch::layernorm_bwd"


def layernorm(x, scale, bias, *, eps: float = 1e-6,
              impl: Optional[str] = None):
    """Differentiable LayerNorm over the last dim: the kernel (or the plain
    version) forward, the kernel (or plain) backward from its saved
    statistics."""
    return _LayerNorm.apply(x.contiguous(), scale, bias, float(eps), impl)


class _BiasGelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, b, impl):
        ctx.save_for_backward(x, b)
        ctx.impl = impl
        return bias_gelu_fwd(x, b, impl=impl)

    @staticmethod
    def backward(ctx, dy):
        x, b = ctx.saved_tensors
        dx, db = bias_gelu_bwd(_rows16(dy), x, b, impl=ctx.impl)
        return dx, db, None


def bias_gelu(x, b, *, impl: Optional[str] = None):
    """Differentiable GELU-tanh(x + b)."""
    return _BiasGelu.apply(x.contiguous(), b, impl)


def lamb_leaf_update(w, g, m, v, *, lr, step: int, b1=0.9, b2=0.999,
                     eps=1e-6, wd=0.01, impl: Optional[str] = None):
    """Full LAMB step of one leaf (``repro/kernels/ops.py``
    ``lamb_leaf_update``): the moment kernel, then the trust ratio
    ||w|| / ||update|| from two torch norms and w - lr * trust * update.
    Returns (w', m', v')."""
    m2, v2, upd = lamb_moments(w, g, m, v, step=step, b1=b1, b2=b2,
                                     eps=eps, wd=wd, impl=impl)
    wnorm = torch.linalg.vector_norm(w.float())
    unorm = torch.linalg.vector_norm(upd)
    one = torch.ones_like(wnorm)
    trust = torch.where(wnorm > 0,
                        torch.where(unorm > 0, wnorm / unorm, one), one)
    return w - upd * (lr * trust), m2, v2


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far in this process, by kernel."""
    return {"flash_fwd": _fa.launches,
            "flash_bwd_prep": _fa.launches_bwd_prep,
            "flash_bwd": _fa.launches_bwd,
            "flash_bwd_post": _fa.launches_bwd_post,
            "paged_decode": _pa.launches, "layernorm": _ln.launches,
            "layernorm_bwd": _ln.launches_bwd, "bias_gelu": _bg.launches,
            "bias_gelu_bwd": _bg.launches_bwd, "lamb_moments": _lu.launches,
            "wkv6": _wkv.launches,
            # the forward's and the backward main pass's launches by q's
            # sequence length S, as "flash_fwd_s<S>" and "flash_bwd_s<S>",
            # for the lengths launched so far
            **{f"flash_fwd_s{s}": n
               for s, n in sorted(_fa.launches_by_seq.items())},
            **{f"flash_bwd_s{s}": n
               for s, n in sorted(_fa.launches_bwd_by_seq.items())},
            # the paged decode's launches by route, as "paged_decode_split"
            # and "paged_decode_walk", for the routes launched so far
            **{f"paged_decode_{r}": n
               for r, n in sorted(_pa.launches_by_route.items())}}


def reset_launch_counts() -> None:
    _fa.launches = _fa.launches_bwd_prep = _fa.launches_bwd = 0
    _fa.launches_bwd_post = 0
    _fa.launches_by_seq.clear()
    _fa.launches_bwd_by_seq.clear()
    _pa.launches_by_route.clear()
    _pa.launches = _ln.launches = _bg.launches = _lu.launches = 0
    _ln.launches_bwd = _bg.launches_bwd = _wkv.launches = 0
