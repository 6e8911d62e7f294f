"""Fused bias + tanh-GELU on the card: wrappers of ``csrc/bias_gelu.cu``.

``bias_gelu`` replaces ``repro/kernels/bias_gelu.py:28`` ``bias_gelu``
(Pallas kernel ``_bias_gelu_kernel``).  ``bias_gelu_bwd`` is its backward,
which the JAX package leaves to XLA's autodiff: a kernel of the port's own
(deterministic: fixed-order column sums, no atomics).  The kernels' design
notes are at the top of the CUDA source.  The wrappers check what the
kernels take, allocate the outputs and scratch, launch on PyTorch's
current stream and count the launches.  The plain versions are
``kernels.ref.bias_gelu_ref`` and ``bias_gelu_bwd_ref``; ``kernels.ops``
picks between them by device and pairs the forward with the backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# rows a tile of the backward (one fp32 partial row of db each)
TILE_ROWS = 64

launches = 0       # forward launches in this process (see ops.launch_counts)
launches_bwd = 0   # backward launches (one a call: both of its kernels)


def _fn():
    fn = build.load("bias_gelu").bias_gelu_fwd
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ptr, ptr, ptr, ctypes.c_int64,
                       ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = build.load("bias_gelu").bias_gelu_bwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32] + [ptr] * 6 + [i32, i32, i32, ptr]
        fn.restype = i32
    return fn


def _check(what, **tensors):
    """What both kernels take: ``x`` (and ``dy``) a contiguous, 16-byte
    aligned (..., d) float32, bfloat16 or float16 CUDA tensor with d a
    multiple of the 16-byte vector, ``b`` (d,) contiguous and aligned, all
    of one dtype.  Dtypes, shapes and alignment are checked before the
    device, so the CPU tests reach every refusal.  Returns d."""
    x = tensors["x"]
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in tensors.values()):
        raise TypeError(f"{what}: " + ", ".join(
            f"{n} {t.dtype}" for n, t in tensors.items()) + "; the kernel "
            "takes float32, bfloat16 or float16, all alike")
    d = x.shape[-1]
    per_vec = 16 // x.element_size()
    rows_ok = all(t.shape == x.shape for n, t in tensors.items() if n != "b")
    if (tensors["b"].shape != (d,) or d % per_vec or not rows_ok
            or any(not t.is_contiguous() or t.data_ptr() % 16
                   for t in tensors.values())):
        raise ValueError(f"{what}: x {tuple(x.shape)} must be contiguous "
                         f"and 16-byte aligned with d a multiple of "
                         f"{per_vec}, b of shape ({d},)"
                         + (", dy of x's shape" if "dy" in tensors else ""))
    build.check_cuda(what, **tensors)
    return d


def bias_gelu(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (..., d) contiguous CUDA tensor, float32, bfloat16 or float16; b:
    (d,) of x's dtype.  Returns GELU(x + b) in x's dtype and shape."""
    global launches
    d = _check("bias_gelu", x=x, b=b)
    out = torch.empty_like(x)
    err = _fn()(_DTYPES[x.dtype], x.data_ptr(), b.data_ptr(), out.data_ptr(),
                x.numel(), d, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "bias_gelu")
    launches += 1
    return out


def bias_gelu_bwd(dy: torch.Tensor, x: torch.Tensor, b: torch.Tensor):
    """The gradient of ``bias_gelu``: dy and x (..., d) contiguous CUDA
    tensors and b (d,), all of one dtype (float32, bfloat16 or float16).
    Returns (dx in x's dtype and shape, db (d,) in b's dtype), the same
    bits from run to run."""
    global launches_bwd
    d = _check("bias_gelu_bwd", x=x, b=b, dy=dy)
    rows = x.numel() // d
    tiles = -(-rows // TILE_ROWS)
    dx = torch.empty_like(x)
    db = torch.empty((d,), dtype=b.dtype, device=x.device)
    part = torch.empty((tiles, d), dtype=torch.float32, device=x.device)
    err = _bwd_fn()(_DTYPES[x.dtype], x.data_ptr(), b.data_ptr(),
                    dy.data_ptr(), dx.data_ptr(), db.data_ptr(),
                    part.data_ptr(), rows, d, TILE_ROWS,
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "bias_gelu_bwd")
    launches_bwd += 1
    return dx, db
