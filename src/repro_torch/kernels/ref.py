"""Plain PyTorch versions of the kernels in this package (port of
``repro/kernels/ref.py``).

On the CPU the kernel wrappers in ``kernels/ops.py`` run these; on the card
``chip_smoke.py`` and the tests hold each hand-written kernel against them.
They repeat the kernels' arithmetic in float32 and are no yardstick of
speed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30
# scores of one block of query rows in ``flash_attention_ref`` (512 MiB of
# fp32)
QUERY_BLOCK_SCORES = 2 ** 27


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """Attention with the flash kernel's masks and outputs.

    q: (B, H, Sq, Dh); k, v: (B, KV, Skv, Dh) with H % KV == 0 (query head h
    reads KV head h // (H // KV)).  Masked logits are set to NEG_INF (-1e30)
    as in the kernel, after the tanh softcap.  Unlike
    ``repro.kernels.ref.flash_attention_ref`` this honours ``window`` and
    ``softcap``.  Returns (out in q's dtype, lse (B, H, Sq) float32) with
    ``lse = m + log(max(l, 1e-30))``.  Query rows are taken in blocks of
    at most ``QUERY_BLOCK_SCORES`` scores, so that long prompts (gemma2's
    8192 tokens) do not hold the whole score matrix at once; each row's
    arithmetic is the same either way.
    """
    b, h, sq, dh = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, kvh, g, sq, dh)
    kf, vf = k.float(), v.float()
    ki = torch.arange(skv, device=q.device)[None, :]
    rows = max(1, QUERY_BLOCK_SCORES // max(1, b * h * skv))
    outs, lses = [], []
    for q0 in range(0, sq, rows):
        s = torch.einsum("bvgqd,bvkd->bvgqk", qg[:, :, :, q0:q0 + rows],
                         kf) * (1.0 / math.sqrt(dh))
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        qi = torch.arange(q0, min(q0 + rows, sq), device=q.device)[:, None]
        mask = torch.ones((qi.shape[0], skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= ki <= qi
        if window:
            mask &= ki > qi - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l = torch.clamp(p.sum(dim=-1), min=1e-30)
        outs.append(torch.einsum("bvgqk,bvkd->bvgqd", p, vf) / l[..., None])
        lses.append(m + torch.log(l))
    out = torch.cat(outs, dim=3) if len(outs) > 1 else outs[0]
    lse = torch.cat(lses, dim=3) if len(lses) > 1 else lses[0]
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


def paged_decode_partials_ref(q, k_pages, v_pages, block_table, kv_len, *,
                              n_split: int, pages_per_split: int,
                              k_scale=None, v_scale=None,
                              softcap: float = 0.0):
    """The split form of ``paged_decode_attention_ref``, as the card's kernel
    computes it: split s of a slot covers pages [s * pages_per_split,
    (s + 1) * pages_per_split) of its table.  Returns fp32 (m, l, acc) per
    split over its live tokens: m (B, H, n_split) the largest logit (-inf
    where the split holds none), l = sum exp(logit - m) (0 there) and
    acc (B, H, n_split, Dh) = sum exp(logit - m) v."""
    b, h, dh = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    mp = block_table.shape[1]
    width = n_split * pages_per_split
    assert width >= mp, "the splits must cover the table"
    bt = block_table.long().clamp(0, n_pages - 1)
    bt = torch.cat([bt, bt.new_zeros((b, width - mp))], dim=1)
    k = k_pages[bt].float()                          # (B, W, ps, KV, Dh)
    v = v_pages[bt].float()
    if k_scale is not None:
        k = k * k_scale.float()[bt][:, :, None, :, None]
        v = v * v_scale.float()[bt][:, :, None, :, None]
    n_tok = pages_per_split * ps
    k = k.reshape(b, n_split, n_tok, kvh, dh)
    v = v.reshape(b, n_split, n_tok, kvh, dh)
    qg = q.float().reshape(b, kvh, h // kvh, dh)
    logits = torch.einsum("bvgd,bskvd->bvgsk", qg, k) / math.sqrt(dh)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    length = kv_len.to(q.device).long().clamp(0, mp * ps)
    idx = torch.arange(width * ps, device=q.device).reshape(n_split, n_tok)
    mask = idx[None] < length[:, None, None]              # (B, S, n_tok)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    m = logits.amax(dim=-1)                               # (B, KV, G, S)
    p = torch.exp(logits - torch.where(torch.isinf(m), 0.0, m)[..., None])
    acc = torch.einsum("bvgsk,bskvd->bvgsd", p, v)
    return (m.reshape(b, h, n_split), p.sum(-1).reshape(b, h, n_split),
            acc.reshape(b, h, n_split, dh))


def paged_combine_ref(m, l, acc, dtype=torch.float32) -> torch.Tensor:
    """(B, H, Dh) from per-split partials (``paged_decode_partials_ref``),
    added in split order; a split with no live token (l == 0) is left out
    and a slot with none gives zeros."""
    live = l > 0
    top = torch.where(live, m, float("-inf")).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - torch.where(live, top, 0.0)), 0.0)
    lsum = torch.zeros_like(l[..., 0])
    osum = torch.zeros_like(acc[..., 0, :])
    for s in range(m.shape[-1]):
        lsum = lsum + l[..., s] * w[..., s]
        osum = osum + acc[..., s, :] * w[..., s, None]
    out = torch.where(lsum[..., None] > 0,
                      osum / lsum.clamp(min=1e-30)[..., None], 0.0)
    return out.to(dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0):
    """FlashAttention-2 backward written out over the whole score matrix
    (the math of ``repro/kernels/flash_attention.py:166-244``, not autograd
    through the forward), so that it can be held against the kernels
    directly.

    q, out, dout: (B, H, Sq, Dh); k, v: (B, KV, Skv, Dh); lse: (B, H, Sq)
    float32 from the forward.  P is recomputed from lse with masked logits
    at NEG_INF after the softcap and zeroed outside the mask; with
    delta = rowsum(dO * O)::

        dV = P^T dO                 dP = dO V^T
        dS = P * (dP - delta) * (1 - (capped / softcap)^2 if softcap)
        dQ = dS K * scale           dK = dS^T Q * scale

    A GQA group's dK and dV are summed over its query heads.  Returns
    (dq, dk, dv) in the dtypes of q, k, v.
    """
    b, h, sq, dh = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qf = q.float().reshape(b, kvh, g, sq, dh)
    dof = dout.float().reshape(b, kvh, g, sq, dh)
    kf, vf = k.float(), v.float()
    delta = (dout.float() * out.float()).sum(-1).reshape(b, kvh, g, sq)
    raw = torch.einsum("bvgqd,bvkd->bvgqk", qf, kf) * scale
    capped = softcap * torch.tanh(raw / softcap) if softcap else raw
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    capped = torch.where(mask, capped, torch.full_like(capped, NEG_INF))
    lsef = lse.float().reshape(b, kvh, g, sq)
    p = torch.exp(capped - lsef[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    dv = torch.einsum("bvgqk,bvgqd->bvkd", p, dof)
    dp = torch.einsum("bvgqd,bvkd->bvgqk", dof, vf)
    ds = p * (dp - delta[..., None])
    if softcap:
        t = torch.where(mask, capped / softcap, torch.zeros_like(capped))
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bvgqk,bvkd->bvgqd", ds, kf) * scale
    dk = torch.einsum("bvgqk,bvgqd->bvkd", ds, qf) * scale
    return (dq.reshape(b, h, sq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def layernorm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6):
    """Row LayerNorm over the last dim with fp32 statistics (the variance
    is the mean of squared deviations, as ``jnp.var``), affine, the output
    in x's dtype.  Returns (y, mean, rstd) with mean and rstd (rows,)
    float32 over the flattened leading dims: the kernel's outputs, which
    the backward reads."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    y = y * scale.float() + bias.float()
    return y.to(x.dtype), mean.reshape(-1), rstd.reshape(-1)


def layernorm_bwd_ref(dy, x, scale, mean, rstd):
    """Gradient of ``layernorm_ref``'s y with respect to x, scale and bias,
    from the saved statistics, in fp32; returned in the dtypes of x, scale
    and scale (bias shares scale's dtype)."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    dyf = dy.float().reshape(-1, d)
    xhat = (xf - mean[:, None]) * rstd[:, None]
    gy = dyf * scale.float()
    dx = rstd[:, None] * (gy - gy.mean(-1, keepdim=True)
                          - xhat * (gy * xhat).mean(-1, keepdim=True))
    dscale = (dyf * xhat).sum(0)
    dbias = dyf.sum(0)
    return (dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype),
            dbias.to(scale.dtype))


GELU_K = math.sqrt(2.0 / math.pi)
GELU_C = 0.044715


def bias_gelu_ref(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The paper's §4.3 example: GELU(x + b) with the tanh approximation,
    computed in fp32 and rounded once to x's dtype."""
    y = x.float() + b.float()
    out = 0.5 * y * (1.0 + torch.tanh(GELU_K * (y + GELU_C * torch.pow(y, 3))))
    return out.to(x.dtype)


def bias_gelu_bwd_ref(dy, x, b):
    """Gradient of ``bias_gelu_ref`` with respect to x and b, in fp32;
    returned in the dtypes of x and b."""
    y = x.float() + b.float()
    t = torch.tanh(GELU_K * (y + GELU_C * torch.pow(y, 3)))
    dgelu = 0.5 * (1.0 + t) + 0.5 * y * (1.0 - t * t) * GELU_K * (
        1.0 + 3.0 * GELU_C * y * y)
    dx = dy.float() * dgelu
    return dx.to(x.dtype), dx.reshape(-1, x.shape[-1]).sum(0).to(b.dtype)


def lamb_moments_ref(w, g, m, v, *, b1=0.9, b2=0.999, eps=1e-6, wd=0.01,
                     step=1):
    """LAMB moment update and the unnormalised update direction, in fp32
    (``repro/kernels/ref.py`` ``lamb_moments_ref``).  The bias corrections
    1 - b**step are taken in float32, as the reference takes them."""
    w, g, m, v = (t.float() for t in (w, g, m, v))
    m2 = b1 * m + (1 - b1) * g
    v2 = b2 * v + (1 - b2) * torch.square(g)
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
    update = (m2 / c1) / (torch.sqrt(v2 / c2) + eps) + wd * w
    return m2, v2, update


def wkv6_ref(r, k, v, logw, u, s0, *, chunk: int = 64):
    """Chunk-parallel RWKV-6 recurrence (``repro/models/rwkv.py:119``
    ``wkv6_chunked``, the math of the Pallas kernel ``_wkv6_kernel``).

    r, k, v, logw: (B, S, H, hs) (logw <= 0, the log of the decay); u:
    (H, hs); s0: (B, H, hs, hs).  ``chunk = min(chunk, S)`` must divide S.
    Per chunk of length L, with c the inclusive cumulative sum of logw over
    the chunk and c_prev = c - logw::

        A[i, j] = sum_c r_i[c] k_j[c] e^{c_prev_i[c] - c_j[c]}   (j < i)
        o_i     = sum_j A[i, j] v_j + (r_i . (u * k_i)) v_i
                  + (r_i * e^{c_prev_i}) S
        S      <- diag(e^{c_L}) S + sum_j (k_j * e^{c_L - c_j})^T v_j

    Every exponent is an ordered difference of cumulative decays, <= 0:
    no q e^{c} / k e^{-c} factorisation.  Computed and returned in float32:
    (o (B, S, H, hs), s_final (B, H, hs, hs)).
    """
    b, s, h, hs = r.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"wkv6: sequence length {s} is not a multiple of "
                         f"the chunk {chunk} (an unmasked prefill longer "
                         "than the chunk must be a whole number of chunks)")
    nc = s // chunk
    f32 = torch.float32

    def chunks(t):  # (B, S, H, hs) -> (nc, B, H, L, hs)
        return t.to(f32).reshape(b, nc, chunk, h, hs).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = (chunks(t) for t in (r, k, v, logw))
    uf = u.to(f32)
    idx = torch.arange(chunk, device=r.device)
    tri_lt = (idx[None, :] < idx[:, None])[None, None, :, :, None]  # j < i
    state = s0.to(f32)
    outs = []
    for ri, ki, vi, wi in zip(rc, kc, vc, wc):    # (B, H, L, hs) each
        c = torch.cumsum(wi, dim=2)
        c_prev = c - wi
        diff = c_prev[:, :, :, None, :] - c[:, :, None, :, :]  # (B,H,L,L,hs)
        e = torch.exp(torch.where(tri_lt, diff,
                                  torch.full_like(diff, float("-inf"))))
        scores = (ri[:, :, :, None, :] * e * ki[:, :, None, :, :]).sum(-1)
        o = scores @ vi
        bonus = (ri * uf[None, :, None, :] * ki).sum(-1)
        o = o + bonus[..., None] * vi
        o = o + (ri * torch.exp(c_prev)) @ state
        c_last = c[:, :, -1:, :]
        k_eff = ki * torch.exp(c_last - c)
        state = torch.exp(c_last[:, :, 0, :, None]) * state + \
            k_eff.transpose(-1, -2) @ vi
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, hs)
    return o, state


WKV_SUB = 16   # rows of a sub-chunk in the card kernel's factorisation


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) cut to TF32 (sign, exponent and the top 10 mantissa
    bits): what a tensor core reads of a float32 operand of a TF32 product,
    and the big part of the card kernel's split."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, mode):
    """a @ b in float32 with the operands as the card's tensor-core
    products read them: ``None`` exact, ``"1x"`` each operand cut to TF32
    once, ``"3x"`` the kernel's split a_small b_big + a_big b_small + a_big
    b_big, where x_big = tf32(x) and x_small = tf32(x - x_big)."""
    if mode is None:
        return a @ b
    ab, bb = tf32(a), tf32(b)
    if mode == "1x":
        return ab @ bb
    if mode != "3x":
        raise ValueError(f"tf32 must be None, '1x' or '3x', got {mode!r}")
    return tf32(a - ab) @ bb + ab @ tf32(b - bb) + ab @ bb


def wkv6_subchunk_ref(r, k, v, logw, u, s0, *, chunk: int = 64,
                      sub: int = WKV_SUB, rounding=None):
    """``wkv6_ref`` in the sub-chunk form of the card's kernel
    (``csrc/wkv6.cu``): used only by the tests, to hold the kernel's
    factorisation and its rounding against the reference on the CPU.

    Each chunk of L rows is cut into sub-chunks of ``sub`` rows (the last
    one shorter when L % sub != 0); c is the inclusive cumulative sum of
    logw over the chunk and c_prev_i = c_{i-1} (0 for the first row).  For
    i in sub-chunk I and j in an earlier sub-chunk, with c_ref the c of the
    last row of sub-chunk I - 1,

        e^{c_prev_i - c_j} = e^{c_prev_i - c_ref} e^{c_ref - c_j},

    both exponents <= 0 (c falls along the chunk), so the off-diagonal
    scores are one product (r_I * e^{c_prev_I - c_ref}) (k_J * e^{c_ref -
    c_J})^T.  The diagonal blocks keep one exponential per (i, j < i, c)
    and the bonus r_i . (u * k_i) on the diagonal.  The products (off-
    diagonal scores, scores x V, (r * e^{c_prev}) S and the state update)
    are rounded as ``rounding`` says (see ``_mm_tf32``).  Returns float32
    (o, s_final) as ``wkv6_ref``."""
    b, s, h, hs = r.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"wkv6: sequence length {s} is not a multiple of "
                         f"the chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32

    def chunks(t):  # (B, S, H, hs) -> (nc, B, H, L, hs)
        return t.to(f32).reshape(b, nc, chunk, h, hs).permute(1, 0, 3, 2, 4)

    mm = lambda x, y: _mm_tf32(x, y, rounding)
    rc, kc, vc, wc = (chunks(t) for t in (r, k, v, logw))
    uf = u.to(f32)[None, :, None, :]
    state = s0.to(f32)
    outs = []
    for ri, ki, vi, wi in zip(rc, kc, vc, wc):    # (B, H, L, hs) each
        c = torch.cumsum(wi, dim=2)
        cp = torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]], dim=2)
        scores = torch.zeros(b, h, chunk, chunk, dtype=f32, device=r.device)
        for lo in range(0, chunk, sub):
            hi = min(lo + sub, chunk)
            n = hi - lo
            diff = cp[:, :, lo:hi, None, :] - c[:, :, None, lo:hi, :]
            lower = torch.ones(n, n, dtype=torch.bool,
                               device=r.device).tril(-1)[:, :, None]
            e = torch.where(lower, torch.exp(torch.minimum(
                diff, torch.zeros((), device=r.device))),
                torch.zeros((), device=r.device))
            blk = (ri[:, :, lo:hi, None, :] * e
                   * ki[:, :, None, lo:hi, :]).sum(-1)
            bonus = (ri[:, :, lo:hi] * uf * ki[:, :, lo:hi]).sum(-1)
            scores[:, :, lo:hi, lo:hi] = blk + torch.diag_embed(bonus)
            if lo:
                cref = c[:, :, lo - 1:lo]
                rt = ri[:, :, lo:hi] * torch.exp(cp[:, :, lo:hi] - cref)
                kt = ki[:, :, :lo] * torch.exp(cref - c[:, :, :lo])
                scores[:, :, lo:hi, :lo] = mm(rt, kt.transpose(-1, -2))
        c_last = c[:, :, -1:]
        o = mm(scores, vi) + mm(ri * torch.exp(cp), state)
        k_eff = ki * torch.exp(c_last - c)
        state = torch.exp(c_last[:, :, 0, :, None]) * state + \
            mm(k_eff.transpose(-1, -2), vi)
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, hs)
    return o, state
