"""FlashAttention forward and backward on the card: wrappers of
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``.

Replace ``repro/kernels/flash_attention.py:107`` ``flash_attention`` (Pallas
kernel ``_flash_kernel``) and ``:247`` ``flash_attention_bwd`` (Pallas
kernels ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``).  The
kernels' design notes (tiling, dead-tile skip, what bounds them) are at the
top of the CUDA sources.  These wrappers check what the kernels take,
allocate the outputs, launch on PyTorch's current stream and count the
launches.  The plain versions are ``kernels.ref.flash_attention_ref`` and
``flash_attention_bwd_ref``; ``kernels.ops`` picks between them by device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

launches = 0       # forward launches in this process (ops.launch_counts)
launches_dq = 0    # backward dq launches
launches_dkv = 0   # backward dk/dv launches


def _fn():
    fn = build.load("flash_fwd").flash_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                       i32, i32, i32, i32, ctypes.c_float, ctypes.c_float,
                       ptr]
        fn.restype = i32
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, out: torch.Tensor = None):
    """q: (B, H, Sq, Dh); k, v: (B, KV, Skv, Dh), CUDA tensors of one dtype
    (float32 or bfloat16), any strides with the head dim contiguous.  GQA
    reads KV head h // (H // KV).  ``out`` (optional, (B, H, Sq, Dh) view of
    any strides with a contiguous head dim) receives the result in place.
    Returns (out in q's dtype, lse (B, H, Sq) float32)."""
    global launches
    b, h, sq, dh = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    _check_operands("flash_attention", q, q=q, k=k, v=v)
    if dh not in _HEAD_DIMS or k.shape[-1] != dh or v.shape != k.shape:
        raise ValueError(f"flash_attention: head dim {dh} (q) / {k.shape} "
                         f"(k) / {v.shape} (v); the kernel takes Dh in "
                         f"{_HEAD_DIMS} and equal k, v shapes")
    if k.shape[0] != b or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not group")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    elif out.shape != q.shape or out.dtype != q.dtype or out.stride(-1) != 1:
        raise ValueError("flash_attention: out must match q's shape and "
                         "dtype with a contiguous head dim")
    _check_rows("flash_attention", q=q, k=k, v=v, out=out)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    err = _fn()(_DTYPES[q.dtype], dh, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), lse.data_ptr(), strides, b, h,
                kvh, sq, skv, int(bool(causal)), int(window), float(softcap),
                1.0 / math.sqrt(dh),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_fwd")
    launches += 1
    return out, lse


def _check_operands(what, ref, **tensors):
    """CUDA tensors of one dtype (float32 or bfloat16) with a contiguous
    last dim."""
    for name, t in tensors.items():
        if t.dtype == torch.float16:
            raise TypeError(f"{what}: {name} is float16; the kernel takes "
                            "float32 or bfloat16 (f16 kernels are not "
                            "written yet)")
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is not a CUDA tensor")
        if t.dtype != ref.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; the kernel "
                            "takes float32 or bfloat16 for all")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name}'s head dim must be contiguous")


def _check_rows(what, **tensors):
    """The bf16 tensor-core kernels move rows as 16-byte vectors."""
    for name, t in tensors.items():
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"{what}: bf16 {name} needs 16-byte aligned "
                             "rows")


def _bwd_fn(name):
    fn = getattr(build.load("flash_bwd"), name)
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        n_out = 1 if name == "flash_bwd_dq" else 2
        fn.argtypes = ([i32, i32] + [ptr] * (6 + n_out + 1)
                       + [i32] * 6 + [ctypes.c_float] * 2 + [ptr])
        fn.restype = i32
    return fn


def _check_bwd(q, k, v, dout, lse, delta):
    b, h, sq, dh = q.shape
    _check_operands("flash_attention_bwd", q, q=q, k=k, v=v, dout=dout)
    if dh not in _HEAD_DIMS or k.shape[-1] != dh or v.shape != k.shape:
        raise ValueError(f"flash_attention_bwd: head dim {dh} (q) / "
                         f"{tuple(k.shape)} (k) / {tuple(v.shape)} (v); the "
                         f"kernels take Dh in {_HEAD_DIMS} and equal k, v "
                         "shapes")
    if k.shape[1] != h:
        raise ValueError(f"flash_attention_bwd: {h} query heads and "
                         f"{k.shape[1]} KV heads; the backward kernels take "
                         "equal head counts (GQA backward is not written)")
    if k.shape[0] != b or dout.shape != q.shape:
        raise ValueError("flash_attention_bwd: q, k, dout do not match")
    for name, t in (("lse", lse), ("delta", delta)):
        if (not t.is_cuda or t.dtype != torch.float32
                or t.shape != (b, h, sq) or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             "contiguous (B, H, Sq) float32 CUDA tensor")


def _grad_like(x):
    """An output laid out as (B, S, H, Dh) in memory, returned as the
    (B, H, S, Dh) view: the model's own layout, so the projections'
    backward reads it without a transpose copy."""
    b, h, s, dh = x.shape
    return torch.empty((b, s, h, dh), dtype=x.dtype,
                       device=x.device).transpose(1, 2)


def _strides(*tensors):
    return (ctypes.c_int64 * (3 * len(tensors)))(
        *(st for t in tensors for st in t.stride()[:3]))


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal=True,
                           window=0, softcap=0.0):
    """dq of FlashAttention (kernel ``flash_bwd_dq``).  q, dout: (B, H, Sq,
    Dh); k, v: (B, H, Skv, Dh); lse and delta = rowsum(dout * out):
    contiguous (B, H, Sq) float32.  Returns dq in q's dtype."""
    global launches_dq
    _check_bwd(q, k, v, dout, lse, delta)
    dq = _grad_like(q)
    _check_rows("flash_attention_bwd", q=q, k=k, v=v, dout=dout, dq=dq)
    b, h, sq, dh = q.shape
    err = _bwd_fn("flash_bwd_dq")(
        _DTYPES[q.dtype], dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, dout, dq), b, h, sq, k.shape[2], int(bool(causal)),
        int(window), float(softcap), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_bwd_dq")
    launches_dq += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal=True,
                            window=0, softcap=0.0):
    """dk and dv of FlashAttention (kernel ``flash_bwd_dkv``); arguments as
    ``flash_attention_bwd_dq``.  Returns (dk, dv) in k's dtype."""
    global launches_dkv
    _check_bwd(q, k, v, dout, lse, delta)
    dk, dv = _grad_like(k), _grad_like(v)
    _check_rows("flash_attention_bwd", q=q, k=k, v=v, dout=dout, dk=dk,
                dv=dv)
    b, h, sq, dh = q.shape
    err = _bwd_fn("flash_bwd_dkv")(
        _DTYPES[q.dtype], dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, dout, dk, dv), b, h, sq, k.shape[2],
        int(bool(causal)), int(window), float(softcap), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_bwd_dkv")
    launches_dkv += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                        softcap=0.0):
    """FlashAttention-2 backward: delta = rowsum(dout * out) as one torch
    reduction (the reference leaves it to XLA), then the dq kernel and the
    dk/dv kernel.  Returns (dq, dk, dv)."""
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    kw = dict(causal=causal, window=window, softcap=softcap)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv
