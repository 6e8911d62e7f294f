"""Paged single-token decode attention on the card: wrapper of
``csrc/paged_decode.cu``.

Replaces ``repro/kernels/paged_attention.py:160`` ``paged_decode_attention``
(Pallas kernel ``_paged_kernel``).  The kernel reads the page pool in the
JAX layout (P, page_size, KV, Dh) through its strides: unlike the Pallas
wrapper, nothing here copies the pool (``jnp.moveaxis`` there is a full-pool
copy per layer per step).  The plain version is
``kernels.ref.paged_decode_attention_ref``; ``kernels.ops`` picks between
them by device.

16-bit and int8 pages of ``SPLIT_PAGES`` tokens (serving's 16 among them)
go to the split kernel: each slot's table is cut into runs of pages
(``split_plan``), one block a run and KV head, and the runs' fp32 partials
are added in run order on the card.  The route and the plan depend on the
shapes only: the wrapper never reads ``kv_len`` or the block table back, so
a decode step does not wait on the card here.  Every other page -- f32
pages (tests and small cases), other page sizes, rows that 16-byte copies
cannot read -- goes to the first port's kernel, one block per (KV head,
slot).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_GROUPS = (1, 2, 4, 8)
_HEAD_DIMS = (64, 128)
SPLIT_PAGES = (8, 16, 32)    # page sizes the split kernel is built for
WARPS = 4                    # warps a block of the split kernel (kWarps)
MAX_PAGES_PER_SPLIT = 32 * WARPS   # a lane holds one page id of its warp

launches = 0   # launches of the kernel in this process (see ops.launch_counts)
# the same launches by route ("split" or "walk"), for the routes launched
launches_by_route: Dict[str, int] = {}


def split_plan(mp: int, batch_heads: int, n_sm: int) -> Tuple[int, int]:
    """(n_split, pages per split) of the split kernel for block tables of
    ``mp`` pages, ``batch_heads`` = B x KV (slot, KV head) pairs and
    ``n_sm`` SMs.  A table is split where the pairs leave SMs idle (about
    one block an SM) or where it holds more than ``MAX_PAGES_PER_SPLIT``
    pages, with at least one page a warp: once every SM has a block, the
    card's memory is the limit and a split only adds its combine (on an
    H100 at the serve geometry, 4 x 32 pairs: 0.0386 ms in 5 splits of 13
    pages, 0.0345 unsplit).  Split s of a slot takes its pages
    [s * pps, (s + 1) * pps), and n_split * pps >= mp; a split that starts
    past the slot's last live page exits at once on the card."""
    want = max(1, n_sm // max(batch_heads, 1))
    pps = min(max(-(-mp // want), WARPS), MAX_PAGES_PER_SPLIT)
    return max(1, -(-mp // pps)), pps


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The split kernel's n tickets on one stream: zeroed once here, and
    set back to 0 on the card by the block that each ticket elects, so no
    call launches a memset."""
    return torch.zeros(n, dtype=torch.int32, device=device)


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    """t's head dim is contiguous and every row of it starts on a multiple
    of ``nbytes`` bytes."""
    size = t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % nbytes == 0 and all(
        s * size % nbytes == 0 for s in t.stride()[:-1])


def _fn():
    fn = build.load("paged_decode").paged_decode
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                       ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
                       ctypes.c_float, ctypes.c_float, ptr]
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
    build.check_cuda("paged_decode_attention", **tensors)
    g = h // kvh
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
        # the walk kernel loads Dh/32 contiguous elements a lane as a vector
        if not _aligned(t, dh // 32 * t.element_size()):
            raise ValueError(f"paged_decode_attention: {name} needs a "
                             "contiguous, vector-aligned head dim")
    # the split kernel copies page rows 16 bytes at a time
    split = k_pages.dtype != torch.float32 and ps in SPLIT_PAGES and \
        _aligned(k_pages, 16) and _aligned(v_pages, 16)
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # n_split 0: the walk kernel
    n_split, pps = (split_plan(mp, b * kvh, _sm_count(q.device.index))
                    if split else (0, 0))
    part_ptr = tickets_ptr = None
    if n_split > 1:
        # each split's fp32 (acc, m, l), and the tickets that elect the
        # last split of a (slot, KV head) to add them
        part = torch.empty(b * kvh * n_split * g * (dh + 2),
                           dtype=torch.float32, device=q.device)
        part_ptr = part.data_ptr()
        tickets_ptr = _tickets(q.device, stream, b * kvh).data_ptr()
    strides = (ctypes.c_int64 * 13)(
        *q.stride()[:2], *k_pages.stride()[:3], *v_pages.stride()[:3],
        *s_strides, block_table.stride(0), *out.stride()[:2])
    err = _fn()(_Q_DTYPES[q.dtype], _PAGE_DTYPES[k_pages.dtype], g, dh,
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks_ptr,
                vs_ptr, block_table.data_ptr(), kv_len.data_ptr(),
                out.data_ptr(), part_ptr, tickets_ptr, strides, b, kvh,
                n_pages, ps, mp, pps, n_split, float(softcap),
                1.0 / math.sqrt(dh), stream)
    build.check(err, "paged_decode")
    launches += 1
    route = "split" if split else "walk"
    launches_by_route[route] = launches_by_route.get(route, 0) + 1
    return out
