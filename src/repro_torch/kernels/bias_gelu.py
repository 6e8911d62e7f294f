"""Fused bias + tanh-GELU on the card: wrapper of ``csrc/bias_gelu.cu``.

Replaces ``repro/kernels/bias_gelu.py:28`` ``bias_gelu`` (Pallas kernel
``_bias_gelu_kernel``).  The kernel's design notes are at the top of the
CUDA source.  The wrapper checks what the kernel takes, allocates the
output, launches on PyTorch's current stream and counts the launch.  The
plain version is ``kernels.ref.bias_gelu_ref``; ``kernels.ops`` picks
between them by device and pairs either with the backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0   # launches of the kernel in this process (see ops.launch_counts)


def _fn():
    fn = build.load("bias_gelu").bias_gelu_fwd
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ptr, ptr, ptr, ctypes.c_int64,
                       ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    return fn


def bias_gelu(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (..., d) contiguous CUDA tensor, float32 or bfloat16; b: (d,) of
    x's dtype.  Returns GELU(x + b) in x's dtype and shape."""
    global launches
    for name, t in (("x", x), ("b", b)):
        if t.dtype == torch.float16:
            raise TypeError(f"bias_gelu: {name} is float16; the kernel takes "
                            "float32 or bfloat16 (f16 kernels are not "
                            "written yet)")
        if not t.is_cuda:
            raise ValueError(f"bias_gelu: {name} is not a CUDA tensor")
    if x.dtype not in _DTYPES or b.dtype != x.dtype:
        raise TypeError(f"bias_gelu: x {x.dtype} and b {b.dtype}; the "
                        "kernel takes float32 or bfloat16, both alike")
    d = x.shape[-1]
    per_vec = 16 // x.element_size()
    if (b.shape != (d,) or d % per_vec or not x.is_contiguous()
            or not b.is_contiguous() or x.data_ptr() % 16
            or b.data_ptr() % 16):
        raise ValueError(f"bias_gelu: x {tuple(x.shape)} must be contiguous "
                         f"and 16-byte aligned with d a multiple of "
                         f"{per_vec}, b of shape ({d},)")
    out = torch.empty_like(x)
    err = _fn()(_DTYPES[x.dtype], x.data_ptr(), b.data_ptr(), out.data_ptr(),
                x.numel(), d, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "bias_gelu")
    launches += 1
    return out
