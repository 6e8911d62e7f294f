"""Kernel dispatch by device (port of ``repro/kernels/ops.py``).

A CUDA tensor goes to the hand-written kernel, and the call raises if the
kernel cannot take it; a CPU tensor goes to the plain PyTorch version in
``kernels/ref.py``.  There is no environment switch and no fallback on
error.  ``impl="torch"`` runs the plain version on any device: it exists for
the tests and ``chip_smoke.py``, which hold the kernels against it on the
card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref


def _use_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    if impl == "torch":
        return False
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}: pass None (by device) or "
                         "'torch' (plain version)")
    return x.is_cuda


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, impl: Optional[str] = None,
                    out: Optional[torch.Tensor] = None):
    """q: (B, H, S, Dh); k, v: (B, KV, S, Dh).  Returns (out, lse).  GQA is
    read by head index in both versions; K and V are not repeated."""
    if _use_kernel(q, impl):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, out=out)
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    if out is not None:
        out.copy_(o)
        o = out
    return o, lse


def paged_decode_attention(q, k_pages, v_pages, block_table, kv_len, *,
                           k_scale=None, v_scale=None, softcap: float = 0.0,
                           impl: Optional[str] = None):
    """q: (B, H, Dh); pages: (P, page_size, KV, Dh); block_table:
    (B, max_pages) int32; kv_len: (B,) int32; ``k_scale``/``v_scale``
    (P, KV) mark int8 pages.  Returns (B, H, Dh)."""
    if _use_kernel(q, impl):
        return _pa.paged_decode_attention(
            q, k_pages, v_pages, block_table, kv_len, k_scale=k_scale,
            v_scale=v_scale, softcap=softcap)
    return ref.paged_decode_attention_ref(
        q, k_pages, v_pages, block_table, kv_len, k_scale=k_scale,
        v_scale=v_scale, softcap=softcap)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far in this process, by kernel."""
    return {"flash_fwd": _fa.launches, "paged_decode": _pa.launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _pa.launches = 0
