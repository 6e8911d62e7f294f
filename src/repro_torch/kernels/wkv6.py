"""RWKV-6 chunk recurrence on the card: wrapper of ``csrc/wkv6.cu``.

Replaces ``repro/kernels/wkv6.py:98`` ``wkv6`` (Pallas kernel
``_wkv6_kernel``).  The kernel's design notes are at the top of the CUDA
source.  The wrapper checks what the kernel takes, allocates the outputs,
launches on PyTorch's current stream and counts the launch.  It passes the
(B, S, H) strides of r, k, v and logw, so the kernel reads them in place
(the reference wrapper transposes each to (B*H, S, hs) first), and sizes
the grid from the shapes alone (``plan``).  The plain version is
``kernels.ref.wkv6_ref``; ``kernels.ops.wkv6`` picks between them by
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZE = 64
MAX_CHUNK = 64

# the plan is sized for an H100's 132 SMs, one block an SM
N_SM = 132

launches = 0   # launches of the kernel in this process (see ops.launch_counts)


def plan(b: int, h: int) -> int:
    """Blocks a (b, h) for B x H heads, from the shapes alone (no device
    query): 2 -- each block owning 32 of the state's 64 value columns and
    recomputing the chunk's scores -- where 2 B H blocks still fit one
    block an SM, else 1 (one block walks a head's chunks).  Two serve
    rwkv6-1.6b's raw prefill at batch 1 or 2 (32 heads); one its batch 4."""
    return 2 if 2 * b * h <= N_SM else 1


def _fn():
    fn = build.load("wkv6").wkv6_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                       ctypes.POINTER(ctypes.c_int64), i32, i32, i32, i32,
                       i32, i32, ptr]
        fn.restype = i32
    return fn


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
         chunk: int = 64):
    """r, k, v: (B, S, H, 64) float32 or bfloat16, any strides with a
    contiguous last dim; logw: (B, S, H, 64) float32, likewise; u: (H, 64)
    in r's dtype (the model's compute and parameter dtypes are one),
    contiguous; s0: (B, H, 64, 64) float32, contiguous.  ``chunk =
    min(chunk, S)`` is at most 64 and divides S.  Returns (o (B, S, H, 64)
    float32, s_final (B, H, 64, 64) float32)."""
    global launches
    named = (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
             ("s0", s0))
    for name, t in named:
        if t.dtype == torch.float16:
            raise TypeError(f"wkv6: {name} is float16; the kernel takes "
                            "float32 or bfloat16 (no serving path is f16: "
                            "only BERT training runs the f16 policy)")
    build.check_cuda("wkv6", **dict(named))
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, u)):
        raise TypeError("wkv6: r, k, v and u must share one dtype, float32 "
                        "or bfloat16")
    if logw.dtype != torch.float32 or s0.dtype != torch.float32:
        raise TypeError("wkv6: logw and s0 must be float32")
    if r.dim() != 4:
        raise ValueError(f"wkv6: r must be (B, S, H, hs), got "
                         f"{tuple(r.shape)}")
    b, s, h, hs = r.shape
    if (hs != HEAD_SIZE or any(t.shape != r.shape for t in (k, v, logw))
            or u.shape != (h, hs) or s0.shape != (b, h, hs, hs)):
        raise ValueError(
            f"wkv6: r, k, v, logw must share a (B, S, H, {HEAD_SIZE}) shape "
            f"with u (H, {HEAD_SIZE}) and s0 (B, H, {HEAD_SIZE}, "
            f"{HEAD_SIZE}); got r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, logw {tuple(logw.shape)}, u "
            f"{tuple(u.shape)}, s0 {tuple(s0.shape)}")
    if (any(t.stride(-1) != 1 for t in (r, k, v, logw))
            or not u.is_contiguous() or not s0.is_contiguous()):
        raise ValueError("wkv6: r, k, v, logw need a contiguous last dim, "
                         "u and s0 must be contiguous")
    if s < 1:
        raise ValueError("wkv6: empty sequence")
    chunk = min(chunk, s)
    if chunk > MAX_CHUNK or s % chunk:
        raise ValueError(f"wkv6: sequence length {s} is not a multiple of "
                         f"the chunk {chunk} (at most {MAX_CHUNK})")
    o = torch.empty((b, s, h, hs), dtype=torch.float32, device=r.device)
    s_final = torch.empty((b, h, hs, hs), dtype=torch.float32,
                          device=r.device)
    ins = (r, k, v, logw)
    strides = (ctypes.c_int64 * 12)(*[t.stride(ax) for ax in (0, 1, 2)
                                      for t in ins])
    aligned = all(t.data_ptr() % 16 == 0 and all(
        t.stride(ax) * t.element_size() % 16 == 0 for ax in (0, 1, 2))
        for t in ins)
    err = _fn()(_DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
                logw.data_ptr(), u.data_ptr(), s0.data_ptr(), o.data_ptr(),
                s_final.data_ptr(), strides, b, h, s, chunk, plan(b, h),
                int(aligned), torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "wkv6")
    launches += 1
    return o, s_final
