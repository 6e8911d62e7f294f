"""Row LayerNorm on the card: wrappers of ``csrc/layernorm.cu``.

``layernorm`` replaces ``repro/kernels/layernorm.py:27`` ``layernorm``
(Pallas kernel ``_layernorm_kernel``).  ``layernorm_bwd`` is its backward,
which the JAX package leaves to XLA's autodiff: a kernel of the port's own
(deterministic: fixed-order column sums, no atomics).  The kernels' design
notes are at the top of the CUDA source.  The wrappers check what the
kernels take, allocate the outputs and scratch, launch on PyTorch's
current stream and count the launches.  The plain versions are
``kernels.ref.layernorm_ref`` and ``layernorm_bwd_ref``; ``kernels.ops``
picks between them by device and pairs the forward with the backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_VECTORS_PER_LANE = 32
# the backward keeps a lane's dscale and dbias sums in registers: rows of
# at most 2048 values, 16 vectors a lane in f32, 8 in 16 bits
_MAX_BWD_ROW = 2048
# The grids are sized for the 132 SMs of an H100 from the row count alone
# (no device query: the backward's order of sums, and with it its bits,
# must not depend on the card).  The forward: blocks of FWD_WARPS warps,
# about FWD_WARPS_PER_SM warps an SM in one wave.  The backward: blocks of
# WARPS_BWD warps (one tile of rows each, one fp32 partial row each), about
# BWD_BLOCKS_PER_SM blocks an SM in one wave.  Both chosen by timing on the
# card (PERF.md): at the training shapes one backward block an SM with
# twice the rows a warp beat two blocks, and 8 to 48 forward warps an SM
# were within a few per cent of each other.
SMS = 132
FWD_WARPS, FWD_WARPS_PER_SM = 4, 16
WARPS_BWD, BWD_BLOCKS_PER_SM = 8, 1

launches = 0       # forward launches in this process (see ops.launch_counts)
launches_bwd = 0   # backward launches (one a call: both of its kernels)


def _fn():
    fn = build.load("layernorm").layernorm_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                       ctypes.c_float, i32, ptr]
        fn.restype = i32
    return fn


def _bwd_fn():
    fn = build.load("layernorm").layernorm_bwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, i32, i32] + [ptr] * 9 + [i32, i32, i32, ptr]
        fn.restype = i32
    return fn


def _check(what, x, params, max_vectors):
    """What both kernels take: x a contiguous, 16-byte aligned (..., d)
    float32, bfloat16 or float16 CUDA tensor with d a multiple of the
    16-byte vector; ``params`` ((name, tensor) of shape (d,)) in x's dtype
    or float32, all alike.  Dtypes, shapes and alignment are checked before
    the device, so the CPU tests reach every refusal.  Returns (rows, d,
    vectors a lane)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x has dtype {x.dtype}; the kernel takes "
                        "float32, bfloat16 or float16")
    pdt = params[0][1].dtype
    if any(t.dtype != pdt for _, t in params) or pdt not in (x.dtype,
                                                             torch.float32):
        raise TypeError(f"{what}: {' and '.join(n for n, _ in params)} "
                        "must share x's dtype or be float32")
    d = x.shape[-1]
    per_vec = 16 // x.element_size()
    if (any(t.shape != (d,) for _, t in params) or d % per_vec
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{what}: x {tuple(x.shape)} must be contiguous "
                         f"and 16-byte aligned with d a multiple of "
                         f"{per_vec}, " + " and ".join(n for n, _ in params)
                         + f" of shape ({d},)")
    lanes = -(-d // per_vec)
    nv = 1
    while 32 * nv < lanes:
        nv *= 2
    if nv > max_vectors:
        raise ValueError(f"{what}: rows of {d} exceed the kernel's "
                         f"{32 * max_vectors * per_vec}")
    build.check_cuda(what, x=x, **dict(params))
    return x.numel() // d, d, nv


def fwd_plan(rows: int):
    """(blocks, rows a warp) of the forward over ``rows`` rows: each warp
    the same number of consecutive rows, as few as fill about one wave of
    FWD_WARPS_PER_SM warps on each of SMS SMs (one row a warp below that,
    so a small call launches only the blocks its rows need)."""
    rpw = max(1, -(-rows // (SMS * FWD_WARPS_PER_SM)))
    return -(-rows // (FWD_WARPS * rpw)), rpw


def bwd_tiles(rows: int):
    """(tiles, rows a tile) of the backward over ``rows`` rows: tiles of
    WARPS_BWD warps with the same number of consecutive rows each, as few
    as fill about one wave of BWD_BLOCKS_PER_SM blocks on each of SMS SMs.
    A function of the row count alone, so the order of every sum is
    too."""
    tile = WARPS_BWD * max(1, -(-rows // (SMS * BWD_BLOCKS_PER_SM
                                          * WARPS_BWD)))
    return -(-rows // tile), tile


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-6):
    """x: (..., d) contiguous CUDA tensor, float32, bfloat16 or float16;
    scale, bias: (d,) in x's dtype or float32.  Returns (y in x's dtype and
    shape, mean (rows,) float32, rstd (rows,) float32)."""
    global launches
    rows, d, nv = _check("layernorm", x, (("scale", scale), ("bias", bias)),
                         _MAX_VECTORS_PER_LANE)
    y = torch.empty_like(x)
    mean = torch.empty((rows,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    err = _fn()(_DTYPES[x.dtype], _DTYPES[scale.dtype], nv, x.data_ptr(),
                scale.contiguous().data_ptr(), bias.contiguous().data_ptr(),
                y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, d,
                float(eps), fwd_plan(rows)[1],
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "layernorm")
    launches += 1
    return y, mean, rstd


def layernorm_bwd(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                  mean: torch.Tensor, rstd: torch.Tensor):
    """The gradient of ``layernorm``'s y: dy and x (..., d) contiguous CUDA
    tensors of one dtype (float32, bfloat16 or float16), scale (d,) in x's
    dtype or float32, mean and rstd the forward's (rows,) float32.  Returns
    (dx in x's dtype and shape, dscale, dbias in scale's dtype), the same
    bits from run to run."""
    global launches_bwd
    if dy.dtype != x.dtype:
        raise TypeError(f"layernorm_bwd: dy {dy.dtype} and x {x.dtype} "
                        "must share a dtype")
    if (dy.shape != x.shape or not dy.is_contiguous() or dy.data_ptr() % 16):
        raise ValueError("layernorm_bwd: dy must be a contiguous, 16-byte "
                         "aligned tensor of x's shape")
    rows = x.numel() // x.shape[-1]
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.dtype != torch.float32 or t.shape != (rows,)
                or not t.is_contiguous()):
            raise ValueError(f"layernorm_bwd: {name} must be the forward's "
                             f"contiguous ({rows},) float32 tensor")
    rows, d, nv = _check("layernorm_bwd", x, (("scale", scale),),
                         _MAX_BWD_ROW * x.element_size() // 16 // 32)
    build.check_cuda("layernorm_bwd", dy=dy, mean=mean, rstd=rstd)
    tiles, tile = bwd_tiles(rows)
    dx = torch.empty_like(x)
    dscale, dbias = (torch.empty((d,), dtype=scale.dtype, device=x.device)
                     for _ in range(2))
    part = torch.empty((tiles, 2 * d), dtype=torch.float32, device=x.device)
    err = _bwd_fn()(_DTYPES[x.dtype], _DTYPES[scale.dtype], nv, x.data_ptr(),
                    dy.data_ptr(), scale.contiguous().data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                    dscale.data_ptr(), dbias.data_ptr(), part.data_ptr(),
                    rows, d, tile,
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "layernorm_bwd")
    launches_bwd += 1
    return dx, dscale, dbias
