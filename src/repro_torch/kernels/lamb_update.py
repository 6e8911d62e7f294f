"""Fused LAMB moment update on the card: wrapper of ``csrc/lamb_update.cu``.

Replaces ``repro/kernels/lamb_update.py:35`` ``lamb_moments`` (Pallas
kernel ``_lamb_kernel``).  The kernel's design notes are at the top of the
CUDA source.  The wrapper checks what the kernel takes, computes the bias
corrections in float32 as the TPU wrapper does, allocates the outputs,
launches on PyTorch's current stream and counts the launch.  The plain
version is ``kernels.ref.lamb_moments_ref``; ``kernels.ops`` picks between
them by device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

launches = 0   # launches of the kernel in this process (see ops.launch_counts)


def _fn():
    fn = build.load("lamb_update").lamb_moments
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = ([ptr] * 7 + [ctypes.c_int64] + [ctypes.c_float] * 8
                       + [ptr])
        fn.restype = ctypes.c_int
    return fn


def lamb_moments(w, g, m, v, *, step: int, b1=0.9, b2=0.999, eps=1e-6,
                 wd=0.01):
    """w, g, m, v: float32 CUDA tensors of one shape, contiguous.  Returns
    (m', v', update), float32 of that shape."""
    global launches
    for name, t in (("w", w), ("g", g), ("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"lamb_moments: {name} has dtype {t.dtype}; the "
                            "kernel takes float32 (the optimizer state)")
        if not t.is_cuda:
            raise ValueError(f"lamb_moments: {name} is not a CUDA tensor")
        if t.shape != w.shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"lamb_moments: {name} must be contiguous, "
                             "16-byte aligned and of w's shape")
    f32 = np.float32
    c1 = f32(1) / (f32(1) - f32(b1) ** f32(step))
    c2 = f32(1) / (f32(1) - f32(b2) ** f32(step))
    m2, v2, upd = (torch.empty_like(w) for _ in range(3))
    err = _fn()(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                m2.data_ptr(), v2.data_ptr(), upd.data_ptr(), w.numel(),
                b1, float(f32(1.0 - b1)), b2, float(f32(1.0 - b2)), eps, wd,
                float(c1), float(c2),
                torch.cuda.current_stream(w.device).cuda_stream)
    build.check(err, "lamb_moments")
    launches += 1
    return m2, v2, upd
