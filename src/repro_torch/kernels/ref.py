"""Plain PyTorch versions of the kernels in this package (port of
``repro/kernels/ref.py``).

On the CPU the kernel wrappers in ``kernels/ops.py`` run these; on the card
``chip_smoke.py`` and the tests hold each hand-written kernel against them.
They repeat the kernels' arithmetic in float32 and are no yardstick of
speed.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """Attention with the flash kernel's masks and outputs.

    q: (B, H, Sq, Dh); k, v: (B, KV, Skv, Dh) with H % KV == 0 (query head h
    reads KV head h // (H // KV)).  Masked logits are set to NEG_INF (-1e30)
    as in the kernel, after the tanh softcap.  Unlike
    ``repro.kernels.ref.flash_attention_ref`` this honours ``window`` and
    ``softcap``.  Returns (out in q's dtype, lse (B, H, Sq) float32) with
    ``lse = m + log(max(l, 1e-30))``.
    """
    b, h, sq, dh = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, kvh, g, sq, dh)
    s = torch.einsum("bvgqd,bvkd->bvgqk", qg, k.float()) * (1.0 / math.sqrt(dh))
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.einsum("bvgqk,bvkd->bvgqd", p, v.float()) / l[..., None]
    lse = m + torch.log(l)
    return (out.reshape(b, h, sq, dh).to(q.dtype),
            lse.reshape(b, h, sq))


def paged_decode_attention_ref(q, k_pages, v_pages, block_table, kv_len, *,
                               k_scale=None, v_scale=None,
                               softcap: float = 0.0) -> torch.Tensor:
    """Paged single-token decode attention.

    q: (B, H, Dh), one new token per slot.  k_pages/v_pages: (P, page_size,
    KV, Dh) global page pool; with ``k_scale``/``v_scale`` (P, KV) the pool is
    int8 and entries dequantise as ``int * scale[page, kv_head]``.
    block_table: (B, max_pages) page ids (clamped to [0, P-1]; page 0 is the
    trash page).  kv_len: (B,) valid token counts; tokens at flat index >=
    kv_len are masked, and a slot with kv_len == 0 yields zeros.
    """
    b, h, dh = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    mp = block_table.shape[1]
    g = h // kvh
    bt = block_table.long().clamp(0, n_pages - 1)
    k = k_pages[bt].float()                             # (B, mp, ps, KV, Dh)
    v = v_pages[bt].float()
    if k_scale is not None:
        k = k * k_scale.float()[bt][:, :, None, :, None]
        v = v * v_scale.float()[bt][:, :, None, :, None]
    k = k.reshape(b, mp * ps, kvh, dh)
    v = v.reshape(b, mp * ps, kvh, dh)
    qg = q.float().reshape(b, kvh, g, dh)
    logits = torch.einsum("bvgd,bkvd->bvgk", qg, k) / math.sqrt(dh)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    idx = torch.arange(mp * ps, device=q.device)[None]
    mask = idx < kv_len.to(q.device).long()[:, None]            # (B, mp*ps)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)                    # empty slots -> zeros
    out = torch.einsum("bvgk,bkvd->bvgd", p, v)
    return out.reshape(b, h, dh).to(q.dtype)
