"""Paged single-token decode attention on the card: wrapper of
``csrc/paged_decode.cu``.

Replaces ``repro/kernels/paged_attention.py:105`` ``paged_decode_attention``
(Pallas kernel ``_paged_kernel``).  The kernel reads the page pool in the
JAX layout (P, page_size, KV, Dh) through its strides: unlike the Pallas
wrapper, nothing here copies the pool (``jnp.moveaxis`` there is a full-pool
copy per layer per step).  The plain version is
``kernels.ref.paged_decode_attention_ref``; ``kernels.ops`` picks between
them by device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_GROUPS = (1, 2, 4, 8)
_HEAD_DIMS = (64, 128)

launches = 0   # launches of the kernel in this process (see ops.launch_counts)


def _fn():
    fn = build.load("paged_decode").paged_decode
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                       ptr, ptr, i32, i32, i32, i32, i32, ctypes.c_float,
                       ctypes.c_float, ptr]
        fn.restype = i32
    return fn


def paged_decode_attention(q, k_pages, v_pages, block_table, kv_len, *,
                           k_scale=None, v_scale=None,
                           softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, Dh) float32/bfloat16; pages: (P, page_size, KV, Dh) of q's
    dtype, or int8 with ``k_scale``/``v_scale`` (P, KV) float32;
    block_table: (B, max_pages) int32; kv_len: (B,) int32.  All CUDA
    tensors.  Returns (B, H, Dh) in q's dtype."""
    global launches
    b, h, dh = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    mp = block_table.shape[1]
    quant = k_scale is not None
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_table": block_table, "kv_len": kv_len}
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t.dtype == torch.float16:
            raise TypeError(f"paged_decode_attention: {name} is float16; the "
                            "kernel takes float32 or bfloat16 (no serving "
                            "path is f16: only BERT training runs the f16 "
                            "policy)")
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"paged_decode_attention: {name} is not a CUDA "
                             "tensor")
    g = h // kvh
    vec = dh // 32
    if q.dtype not in _Q_DTYPES or k_pages.dtype not in _PAGE_DTYPES or \
            v_pages.dtype != k_pages.dtype:
        raise TypeError("paged_decode_attention: q must be float32/bfloat16 "
                        "and both page pools of one dtype")
    if quant != (k_pages.dtype == torch.int8) or (quant and (
            v_scale is None or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32)):
        raise TypeError("paged_decode_attention: int8 pages need float32 "
                        "k_scale and v_scale, and only int8 pages take them")
    if not quant and k_pages.dtype != q.dtype:
        raise TypeError("paged_decode_attention: float pages must have q's "
                        "dtype")
    if h % kvh or g not in _GROUPS or dh not in _HEAD_DIMS or \
            v_pages.shape != k_pages.shape or k_pages.shape[-1] != dh:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}: the kernel takes H/KV in "
                         f"{_GROUPS} and Dh in {_HEAD_DIMS}")
    if block_table.dtype != torch.int32 or kv_len.dtype != torch.int32 or \
            block_table.shape[0] != b or tuple(kv_len.shape) != (b,) or \
            block_table.stride(-1) != 1 or not kv_len.is_contiguous():
        raise ValueError("paged_decode_attention: block_table (B, max_pages) "
                         "and kv_len (B,) must be int32 with a contiguous "
                         "last dim")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        # the kernel loads Dh/32 contiguous elements per lane as one vector
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) or \
                t.data_ptr() % (vec * t.element_size()):
            raise ValueError(f"paged_decode_attention: {name} needs a "
                             "contiguous, vector-aligned head dim")
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    if quant:
        if k_scale.shape != (n_pages, kvh) or v_scale.shape != (n_pages, kvh) \
                or k_scale.stride() != v_scale.stride():
            raise ValueError("paged_decode_attention: scales must be (P, KV) "
                             "with equal strides")
        s_strides = k_scale.stride()
        ks_ptr, vs_ptr = k_scale.data_ptr(), v_scale.data_ptr()
    else:
        s_strides, ks_ptr, vs_ptr = (0, 0), None, None
    strides = (ctypes.c_int64 * 13)(
        *q.stride()[:2], *k_pages.stride()[:3], *v_pages.stride()[:3],
        *s_strides, block_table.stride(0), *out.stride()[:2])
    err = _fn()(_Q_DTYPES[q.dtype], _PAGE_DTYPES[k_pages.dtype], g, dh,
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks_ptr,
                vs_ptr, block_table.data_ptr(), kv_len.data_ptr(),
                out.data_ptr(), strides, b, kvh, n_pages, ps, mp,
                float(softcap), 1.0 / math.sqrt(dh),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode")
    launches += 1
    return out
