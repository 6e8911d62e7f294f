"""FlashAttention forward and backward on the card: wrappers of
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``.

Replace ``repro/kernels/flash_attention.py:107`` ``flash_attention`` (Pallas
kernel ``_flash_kernel``) and ``:247`` ``flash_attention_bwd`` (Pallas
kernels ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``; here a
pre-pass, one fused main pass and a post-pass).  The kernels' design notes
(tiling, dead-tile skip, what bounds them) are at the top of the CUDA
sources.  These wrappers check what the kernels take, allocate the outputs,
launch on PyTorch's current stream and count the launches.  The plain
versions are ``kernels.ref.flash_attention_ref`` and
``flash_attention_bwd_ref``; ``kernels.ops`` picks between them by device.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

launches = 0            # forward launches in this process (ops.launch_counts)
# forward launches by q's sequence length
launches_by_seq = collections.Counter()
launches_bwd_prep = 0   # backward pre-pass launches
launches_bwd = 0        # backward main-pass launches
launches_bwd_post = 0   # backward post-pass launches (bf16 only)
# backward main-pass launches by q's sequence length
launches_bwd_by_seq = collections.Counter()


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
    Returns (out in q's dtype, lse (B, H, Sq) float32).  The source picks
    the kernel by (dtype, Dh): bf16 at Dh 64 and 128 the Hopper one (wgmma
    on TMA-loaded tiles), bf16 at 32 the mma.sync one, float32 the CUDA-core
    one."""
    global launches
    b, h, sq, dh = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    _check_operands("flash_attention", q, q=q, k=k, v=v)
    _check_cuda("flash_attention", q=q, k=k, v=v)
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
    launches_by_seq[sq] += 1
    return out, lse


def _check_operands(what, ref, **tensors):
    """One dtype (float32 or bfloat16) with a contiguous last dim."""
    for name, t in tensors.items():
        if t.dtype == torch.float16:
            raise TypeError(f"{what}: {name} is float16; the kernel takes "
                            "float32 or bfloat16 (f16 kernels are not "
                            "written yet)")
        if t.dtype != ref.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; the kernel "
                            "takes float32 or bfloat16 for all")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name}'s head dim must be contiguous")


def _check_cuda(what, **tensors):
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is not a CUDA tensor")


def _check_rows(what, **tensors):
    """The bf16 tensor-core kernels move rows as 16-byte vectors."""
    for name, t in tensors.items():
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"{what}: bf16 {name} needs 16-byte aligned "
                             "rows")


def _bwd_fn():
    fn = build.load("flash_bwd").flash_bwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # parts, dtype, D; q, k, v, out, dout, lse, lse2, delta; pitch; dq,
        # dq_acc, dk, dv, strides; B, H, Sq, Skv, causal, window; softcap,
        # scale; stream
        fn.argtypes = ([i32] * 3 + [ptr] * 8 + [i32] + [ptr] * 5 + [i32] * 6
                       + [ctypes.c_float] * 2 + [ptr])
        fn.restype = i32
    return fn


def _check_bwd(q, k, v, out, lse, dout):
    """What the backward kernels take, checked before the device so that
    the CPU tests reach every refusal: float32 or bfloat16 throughout,
    equal head counts, Dh in _HEAD_DIMS, bf16 rows 16-byte aligned, then
    CUDA tensors."""
    b, h, sq, dh = q.shape
    what = "flash_attention_bwd"
    _check_operands(what, q, q=q, k=k, v=v, out=out, dout=dout)
    if dh not in _HEAD_DIMS or k.shape[-1] != dh or v.shape != k.shape:
        raise ValueError(f"{what}: head dim {dh} (q) / {tuple(k.shape)} (k) "
                         f"/ {tuple(v.shape)} (v); the kernels take Dh in "
                         f"{_HEAD_DIMS} and equal k, v shapes")
    if k.shape[1] != h:
        raise ValueError(f"{what}: {h} query heads and {k.shape[1]} KV "
                         "heads; the backward kernels take equal head "
                         "counts (GQA backward is not written)")
    if k.shape[0] != b or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{what}: q, k, out, dout do not match")
    _check_rows(what, q=q, k=k, v=v, out=out, dout=dout)
    _check_cuda(what, q=q, k=k, v=v, out=out, dout=dout, lse=lse)
    if (lse.dtype != torch.float32 or lse.shape != (b, h, sq)
            or not lse.is_contiguous()):
        raise ValueError(f"{what}: lse must be a contiguous (B, H, Sq) "
                         "float32 CUDA tensor")


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


PREP, MAIN, POST = 1, 2, 4   # the backward's launches (``parts``)
# keys per block of the bf16 main pass (HC and BC of csrc/flash_bwd.cu,
# which refuses a missing accumulator over more than one such tile)
KV_TILE = 128


def bwd_buffers(q, skv):
    """(delta, lse2, dq_acc) for q's shape over ``skv`` keys: per-row fp32
    arrays (in bf16 with rows padded to the 64-row tiles the kernels copy
    whole) and, in bf16 over more than one KV_TILE, the fp32 dQ
    accumulator (over one, the one block that sees a q row writes dq)."""
    b, h, sq, dh = q.shape
    if q.dtype != torch.bfloat16:
        return (torch.empty((b, h, sq), dtype=torch.float32,
                            device=q.device), None, None)
    rows = torch.empty((2, b, h, -(-sq // 64) * 64), dtype=torch.float32,
                       device=q.device)
    acc = (torch.empty((b, h, sq, dh), dtype=torch.float32, device=q.device)
           if skv > KV_TILE else None)
    return rows[0], rows[1], acc


def bwd_parts(buffers):
    """The launches ``flash_attention_bwd`` makes with ``buffers``: the
    post-pass only where there is an accumulator to read."""
    return PREP | MAIN | (POST if buffers[2] is not None else 0)


def bwd_launch(parts, q, k, v, out, lse, dout, buffers, grads, *, causal,
               window, softcap):
    """In one call, the launches of ``csrc/flash_bwd.cu`` that ``parts``
    names (PREP, MAIN, POST: the source's note says what each does), on
    operands ``flash_attention_bwd`` has checked, ``buffers`` from
    ``bwd_buffers`` (or with an accumulator where it would have none) and
    ``grads`` = (dq, dk, dv).  chip_smoke.py times each alone."""
    global launches_bwd_prep, launches_bwd, launches_bwd_post
    b, h, sq, dh = q.shape
    delta, lse2, acc = buffers
    dq, dk, dv = grads
    if parts & POST and acc is None:
        raise ValueError("flash_attention_bwd: the post-pass reads the dQ "
                         "accumulator, and there is none")
    err = _bwd_fn()(
        parts, _DTYPES[q.dtype], dh, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        None if lse2 is None else lse2.data_ptr(), delta.data_ptr(),
        delta.shape[-1], dq.data_ptr(), None if acc is None else
        acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, out, dout, dq, dk, dv), b, h, sq, k.shape[2],
        int(bool(causal)), int(window), float(softcap), 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_bwd")
    launches_bwd_prep += bool(parts & PREP)
    launches_bwd += bool(parts & MAIN)
    launches_bwd_post += bool(parts & POST)
    if parts & MAIN:
        launches_bwd_by_seq[sq] += 1


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                        softcap=0.0):
    """FlashAttention-2 backward (kernels of ``csrc/flash_bwd.cu``).  q,
    out, dout: (B, H, Sq, Dh); k, v: (B, H, Skv, Dh), CUDA tensors of one
    dtype, any (batch, head, seq) strides with a contiguous head dim; lse:
    contiguous (B, H, Sq) float32 from the forward.  Launches the pre-pass
    (delta), the main pass and, in bf16, the post-pass.  Returns (dq, dk,
    dv) in the model's (B, S, H, Dh) layout, seen as (B, H, S, Dh)."""
    _check_bwd(q, k, v, out, lse, dout)
    grads = (_grad_like(q), _grad_like(k), _grad_like(v))
    buffers = bwd_buffers(q, k.shape[2])
    bwd_launch(bwd_parts(buffers), q, k, v, out, lse, dout, buffers, grads,
               causal=causal, window=window, softcap=softcap)
    return grads
