"""Row LayerNorm on the card: wrapper of ``csrc/layernorm.cu``.

Replaces ``repro/kernels/layernorm.py:27`` ``layernorm`` (Pallas kernel
``_layernorm_kernel``).  The kernel's design notes are at the top of the
CUDA source.  The wrapper checks what the kernel takes, allocates the
outputs, launches on PyTorch's current stream and counts the launch.  The
plain version is ``kernels.ref.layernorm_ref``; ``kernels.ops`` picks
between them by device and pairs either with the backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VECTORS_PER_LANE = 32

launches = 0   # launches of the kernel in this process (see ops.launch_counts)


def _fn():
    fn = build.load("layernorm").layernorm_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                       ctypes.c_float, ptr]
        fn.restype = i32
    return fn


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-6):
    """x: (..., d) contiguous CUDA tensor, float32 or bfloat16; scale, bias:
    (d,) in x's dtype or float32.  Returns (y in x's dtype and shape, mean
    (rows,) float32, rstd (rows,) float32)."""
    global launches
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if t.dtype == torch.float16:
            raise TypeError(f"layernorm: {name} is float16; the kernel takes "
                            "float32 or bfloat16 (f16 kernels are not "
                            "written yet)")
        if not t.is_cuda:
            raise ValueError(f"layernorm: {name} is not a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"layernorm: x has dtype {x.dtype}; the kernel "
                        "takes float32 or bfloat16")
    if scale.dtype != bias.dtype or scale.dtype not in (x.dtype,
                                                        torch.float32):
        raise TypeError("layernorm: scale and bias must share x's dtype or "
                        "be float32")
    d = x.shape[-1]
    per_vec = 16 // x.element_size()
    if (scale.shape != (d,) or bias.shape != (d,) or d % per_vec
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"layernorm: x {tuple(x.shape)} must be contiguous "
                         f"and 16-byte aligned with d a multiple of "
                         f"{per_vec}, scale and bias of shape ({d},)")
    lanes = -(-d // per_vec)
    nv = 1
    while 32 * nv < lanes:
        nv *= 2
    if nv > _MAX_VECTORS_PER_LANE:
        raise ValueError(f"layernorm: rows of {d} exceed the kernel's "
                         f"{32 * _MAX_VECTORS_PER_LANE * per_vec}")
    rows = x.numel() // d
    y = torch.empty_like(x)
    mean = torch.empty((rows,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    err = _fn()(_DTYPES[x.dtype], _DTYPES[scale.dtype], nv, x.data_ptr(),
                scale.contiguous().data_ptr(), bias.contiguous().data_ptr(),
                y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, d,
                float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "layernorm")
    launches += 1
    return y, mean, rstd
