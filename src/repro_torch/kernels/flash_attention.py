"""FlashAttention forward on the card: wrapper of ``csrc/flash_fwd.cu``.

Replaces ``repro/kernels/flash_attention.py:107`` ``flash_attention`` (Pallas
kernel ``_flash_kernel``).  The kernel's design notes (tiling, dead-tile
skip, what bounds it) are at the top of the CUDA source.  This wrapper
checks what the kernel takes, allocates the outputs, launches on PyTorch's
current stream and counts the launch.  The plain version is
``kernels.ref.flash_attention_ref``; ``kernels.ops`` picks between them by
device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

launches = 0   # launches of the kernel in this process (see ops.launch_counts)


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is not a CUDA tensor")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: {name} has dtype {t.dtype}; "
                            "the kernel takes float32 or bfloat16 for all")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             "contiguous")
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
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel moves rows as 16-byte vectors
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
                raise ValueError(f"flash_attention: bf16 {name} needs "
                                 "16-byte aligned rows")
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
