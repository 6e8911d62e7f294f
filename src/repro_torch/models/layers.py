"""Layer library (port of the decoder and encoder subsets of
``repro/models/layers.py``): RMSNorm and LayerNorm, RoPE, causal,
sliding-window and bidirectional attention (QKV biases and the logit
softcap included) with the decoder's contiguous, ring and paged KV caches,
cross-attention over an encoder's output or its per-slot cross cache
(whisper), query/key norms (qwen3-moe), the SwiGLU, GeGLU and GELU MLPs,
and the token embedding with learned positions (from a scalar or a
per-slot offset) or the sqrt(d_model) scale.  Rotary positions are RoPE's
(B, S) or qwen2-vl's M-RoPE over (3, B, S) (temporal, height, width)
triples, whose sections split the Dh/2 frequency slots among the three
axes (``apply_mrope``, ``position_encode``).

Dtype discipline as in the reference: matmuls run in
``policy.compute_dtype``; norms, softmax and logits run in
``policy.reduce_dtype`` (fp32).  A bf16 ``torch.matmul`` rounds its output
to bf16, so where the reference asks XLA for fp32 results of bf16 operands
(``preferred_element_type``) the operands are upcast first.

Three of the paper's fused kernels sit on the encoder's path: LayerNorm
(``kops.layernorm``), bias + GELU (``kops.bias_gelu``) and bidirectional
attention through the flash forward and backward kernels
(``kops.flash_attention_vjp``).  The decoder's causal self-attention
trains through the same pair at S^2 > 512^2 (``chunked_attention``).  The
reference computes the same functions in jnp on this path; the tests hold
the two against each other.

Caches are updated in place (the reference rebuilds arrays): a decode write
goes straight into the page pool or ring stripe, and the functions return
the same dict they were given.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.kernels import ops as kops

Params = dict


def trunc_normal(shape, generator: torch.Generator, *, stddev: float = 0.02,
                 dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2], as the
    reference's ``trunc_normal``.  Drawn in fp32 on ``device`` and then cast,
    so large weights never pass through the host."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev, 2.0 * stddev,
                                generator=generator)
    return t.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, *, dtype=torch.float32,
              device="cpu") -> Params:
    d = cfg.d_model
    if cfg.norm_kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def apply_norm(params: Params, x: torch.Tensor, cfg: ModelConfig,
               policy: Policy, *, impl: Optional[str] = None
               ) -> torch.Tensor:
    """RMSNorm or LayerNorm (``cfg.norm_kind``) with ``cfg.norm_eps``,
    statistics in fp32, output in the compute dtype.  LayerNorm goes
    through the kernel, which returns x's dtype (the encoder's activations
    are already in the compute dtype)."""
    if cfg.norm_kind == "layernorm":
        y = kops.layernorm(x, params["scale"], params["bias"],
                           eps=cfg.norm_eps, impl=impl)
        return y.to(policy.compute_dtype)
    xf = x.to(policy.reduce_dtype)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps)
    y = y * params["scale"].to(policy.reduce_dtype)
    return y.to(policy.compute_dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """The split-half rotation of x (B, S, H, Dh) in fp32, in x's dtype."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S).  Split-half convention: the
    first and second halves of Dh are the two rotated coordinates."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs      # (B,S,Dh/2)
    return _rotate(x, torch.cos(angles)[:, :, None, :],
                   torch.sin(angles)[:, :, None, :])


def _mrope_cos_sin(positions3: torch.Tensor, dh: int, theta: float,
                   sections):
    """(cos, sin) (B, S, 1, Dh/2) fp32 of M-RoPE's angles: frequency slot j
    turns by the position of its section's axis."""
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"Dh/2 = {dh // 2}")
    dev = positions3.device
    freqs = rope_freqs(dh, theta, dev)                            # (Dh/2,)
    # slot j's axis: the number of section ends at or below j (made on the
    # device from Python ints: no host copy, no sync in a decode step)
    slot = torch.arange(dh // 2, device=dev)
    sect_id = torch.zeros_like(slot)
    end = 0
    for n in sections[:-1]:
        end += n
        sect_id += slot >= end                                    # (Dh/2,)
    pos = positions3.to(torch.float32)[sect_id]                  # (Dh/2,B,S)
    angles = pos.movedim(0, -1) * freqs                          # (B,S,Dh/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: (B, S, H, Dh); positions3: (3, B, S),
    the (temporal, height, width) position of each token.  ``sections``
    partition the Dh/2 frequency slots among the three axes in order:
    slot j turns by the position of its section's axis.  Computed in fp32
    and returned in x's dtype; three equal axes give ``apply_rope``'s
    numbers."""
    return _rotate(x, *_mrope_cos_sin(positions3, x.shape[-1], theta,
                                      sections))


def position_encode(q: torch.Tensor, k: torch.Tensor,
                    positions: torch.Tensor, cfg: ModelConfig):
    """q and k rotated at ``positions``: RoPE at (B, S), M-RoPE at (3, B,
    S) over ``cfg.mrope_sections`` (its angles made once for both);
    learned or no positions leave them as they are (those are added at
    the embedding)."""
    if cfg.pos_kind == "rope":
        if positions.dim() != 2:
            raise ValueError("rope takes (B, S) positions")
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.pos_kind == "mrope":
        if positions.dim() != 3:
            raise ValueError("mrope takes (3, B, S) positions")
        cs = _mrope_cos_sin(positions, q.shape[-1], cfg.rope_theta,
                            cfg.mrope_sections)
        return _rotate(q, *cs), _rotate(k, *cs)
    return q, k


def rms_norm_simple(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in fp32, returned in x's dtype (the
    reference's ``rms_norm_simple``): qwen3's query/key norms over Dh."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, generator: torch.Generator, *,
                   dtype=torch.float32, device="cpu") -> Params:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std_o = 0.02 / math.sqrt(2 * cfg.n_layers)
    kw = dict(generator=generator, dtype=dtype, device=device)
    params = {
        "wq": trunc_normal((d, h, dh), **kw),
        "wk": trunc_normal((d, kv, dh), **kw),
        "wv": trunc_normal((d, kv, dh), **kw),
        "wo": trunc_normal((h, dh, d), stddev=std_o, **kw),
    }
    if cfg.qkv_bias:   # zeros at init, as the reference's
        params.update(
            bq=torch.zeros((h, dh), dtype=dtype, device=device),
            bk=torch.zeros((kv, dh), dtype=dtype, device=device),
            bv=torch.zeros((kv, dh), dtype=dtype, device=device))
    if cfg.qk_norm:    # ones at init, as the reference's
        params.update(q_norm=torch.ones((dh,), dtype=dtype, device=device),
                      k_norm=torch.ones((dh,), dtype=dtype, device=device))
    return params


def _soft_cap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def naive_attention(q, k, v, *, causal: bool, window: int = 0,
                    softcap: float = 0.0, q_offset=0,
                    kv_len: Optional[torch.Tensor] = None,
                    reduce_dtype=torch.float32) -> torch.Tensor:
    """Reference attention.  q: (B, Sq, H, Dh); k, v: (B, Skv, KV, Dh).  GQA
    via head grouping.  ``q_offset`` (int or 0-d tensor) is the absolute
    position of the first query: the causal mask is ``k <= q + q_offset``,
    and a ``window`` keeps only ``k > q + q_offset - window``.
    ``kv_len``: scalar or (B,) valid KV lengths.  Logits and the PV product
    are taken in ``reduce_dtype`` from upcast operands; the probabilities
    are rounded to v's dtype first, as in the reference.  Fully masked rows
    give zeros."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.to(reduce_dtype).reshape(b, sq, kvh, g, dh)
    logits = torch.einsum("bqvgd,bkvd->bvgqk", qg,
                          k.to(reduce_dtype)) / math.sqrt(dh)
    logits = _soft_cap(logits, softcap)
    qi = q_offset + torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, device=q.device)
        if kvl.ndim:  # (B,) per-slot valid lengths
            mask = mask[None] & (ki[None] < kvl[:, None, None])
        else:
            mask = mask & (ki < kvl)
    if mask.ndim == 2:
        mask = mask[None]
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)        # fully-masked rows
    out = torch.einsum("bvgqk,bkvd->bqvgd",
                       probs.to(v.dtype).to(reduce_dtype), v.to(reduce_dtype))
    return out.reshape(b, sq, h, dh)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      softcap: float = 0.0,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Long self-attention.  q: (B, S, H, Dh); k, v: (B, S, KV, Dh);
    ``window`` > 0 masks keys ``window`` or more positions back.

    Routed to the flash kernel under the reference's conditions
    (``layers.py:396``): Sq == Skv and Sq % 128 == 0.  The kernel reads the
    (B, S, H, Dh) activations through strides and writes its output in that
    layout, so no transpose is copied.  A call that autograd records
    (training) goes through ``kops.flash_attention_vjp``: the same forward
    kernel, paired with the flash backward kernels, as the reference's
    custom VJP pairs its own.  The backward kernels take equal query and
    KV head counts, so a grouped-query call first expands K and V over the
    group (query head h reads KV head h // g, as ``jnp.repeat`` does before
    the reference's pair): autograd then sums dK and dV over the group, a
    fixed-order sum.  A call autograd does not record (serving) reads GQA
    in the forward kernel natively, writes into ``out=`` and saves nothing.
    Otherwise the reference runs its jnp chunk scan, which is the same math
    as ``naive_attention``; the port has no counterpart of that scan and
    takes ``naive_attention``.
    """
    sq, skv = q.shape[1], k.shape[1]
    t = lambda x: x.transpose(1, 2)  # (B,S,H,D) <-> (B,H,S,D) views
    if sq == skv and sq % 128 == 0 and torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        b, _, h, dh = q.shape
        kvh = k.shape[2]
        if h != kvh:
            k, v = (x[:, :, :, None].expand(b, skv, kvh, h // kvh, dh)
                    .reshape(b, skv, h, dh) for x in (k, v))
        return t(kops.flash_attention_vjp(t(q), t(k), t(v), causal=causal,
                                          window=window, softcap=softcap,
                                          impl=impl))
    if sq == skv and sq % 128 == 0:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        kops.flash_attention(t(q), t(k), t(v), causal=causal, window=window,
                             softcap=softcap, impl=impl, out=t(out))
        return out
    return naive_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)


def _project_kv(params: Params, src: torch.Tensor, cfg: ModelConfig,
                cdt) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V (B, S, KV, Dh) of ``src`` (B, S, d) in ``cdt``, with the
    K/V biases and the key norm where the config has them."""
    b, s, d = src.shape
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    sc = src.to(cdt).reshape(b * s, d)
    k = (sc @ params["wk"].to(cdt).reshape(d, kv * dh)).reshape(b, s, kv, dh)
    v = (sc @ params["wv"].to(cdt).reshape(d, kv * dh)).reshape(b, s, kv, dh)
    if cfg.qkv_bias:
        k = k + params["bk"].to(cdt)
        v = v + params["bv"].to(cdt)
    if cfg.qk_norm:
        k = rms_norm_simple(k, params["k_norm"], cfg.norm_eps)
    return k, v


def apply_attention(params: Params, x: torch.Tensor, cfg: ModelConfig,
                    policy: Policy, *, mixer_kind: str = "attn",
                    positions: Optional[torch.Tensor] = None,
                    kv_source: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None,
                    cache_pos: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    static_kv: bool = False,
                    return_cache: bool = False,
                    impl: Optional[str] = None):
    """Self-attention with an optional KV cache, or cross-attention.
    Returns (y, cache_or_None).

    * ``static_kv=True``: cross-attention (the reference's form): the
      queries over K and V projected from ``kv_source``, the encoder's
      output (B, Se, d), in a prefill or a training step, or read verbatim
      from ``cache`` {"k", "v"} (B, Se, KV, Dh) in a decode step, which
      never writes it.  No mask, no RoPE; the plain ``naive_attention`` in
      both forms, as in the reference (no Pallas kernel there: the (Sq,
      Se) scores with Sq != Se).  With ``return_cache`` the cache is the K
      and V just projected (in the compute dtype; the caller writes them
      into its cross cache), or the cache it read.

    * ``mixer_kind="attn_bidir"`` (the encoder): no cache, no mask, through
      the flash forward and backward kernels at every length
      (``kops.flash_attention_vjp``, differentiable).  The reference takes
      its jnp ``naive_attention`` at S <= 512, the same function.
    * ``"attn"``, ``"attn_global"`` and ``"attn_local"``, no cache: causal
      over the prompt's own K/V (returned as {"k", "v"} when
      ``return_cache``), a local layer within ``cfg.sliding_window``; long
      prompts go through ``chunked_attention`` (differentiable under
      autograd: training).  With a cache the caller passes ``"attn"``: the
      ring of a local layer holds only its window, so ``kv_len`` is the
      window and no mask is applied.
    * contiguous ring cache {"k", "v"} (B, Smax, KV, Dh): the decode token is
      written at ring index ``cache_pos`` (B,) in place, and the query
      attends the slot's ``kv_len`` valid rows.  S > 1 tokens (the suffix
      prefill, resuming at a cached prefix) are written at rows
      [cache_pos, cache_pos + S) of a scalar ``cache_pos`` and attend
      causally from there (``q_offset``).
    * paged cache {"k_pages", "v_pages", "block_table"[, "k_scale",
      "v_scale"]}: the token is written through
      ``block_table[slot, pos // page_size]`` in place (int8 pages
      requantise their page), and the query attends through the paged-decode
      kernel.  A write past the slot's capacity goes to the trash page 0.
    ``cfg.qkv_bias`` adds ``bq``/``bk``/``bv`` after the projections, and
    ``cfg.qk_norm`` then norms each query and key head (``q_norm``,
    ``k_norm``: ``rms_norm_simple`` over Dh), both before RoPE, on every
    path: the K a cache holds is normed and rotated.  ``impl`` is passed to
    the kernels (see ``kernels/ops.py``).
    """
    if mixer_kind not in ("attn", "attn_local", "attn_global",
                          "attn_bidir"):
        raise NotImplementedError(f"{mixer_kind} mixers: the port runs "
                                  "attn, attn_local, attn_global and "
                                  "attn_bidir")
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if mixer_kind == "attn_local" else 0
    softcap = cfg.attn_logit_softcap
    cdt = policy.compute_dtype

    xc = x.to(cdt).reshape(b * s, d)
    q = (xc @ params["wq"].to(cdt).reshape(d, h * dh)).reshape(b, s, h, dh)
    if static_kv and kv_source is None:
        if cache is None:
            raise ValueError("cross-attention needs the encoder output or a "
                             "cross cache")
        k, v = cache["k"], cache["v"]
    else:
        k, v = _project_kv(params, x if kv_source is None else kv_source,
                           cfg, cdt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(cdt)
    if cfg.qk_norm:
        q = rms_norm_simple(q, params["q_norm"], cfg.norm_eps)
    if cfg.pos_kind in ("rope", "mrope") and not static_kv:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
            if cfg.pos_kind == "mrope":
                positions = positions[None].expand(3, b, s)
        q, k = position_encode(q, k, positions, cfg)

    new_cache = None
    if static_kv:
        if return_cache:
            new_cache = {"k": k, "v": v} if kv_source is not None else cache
        out = naive_attention(q, k, v, causal=False, softcap=softcap,
                              reduce_dtype=policy.reduce_dtype)
    elif mixer_kind == "attn_bidir":
        if cache is not None or return_cache:
            raise ValueError("bidirectional attention keeps no KV cache")
        t = lambda z: z.transpose(1, 2)  # (B,S,H,D) <-> (B,H,S,D) views
        out = t(kops.flash_attention_vjp(t(q), t(k), t(v), causal=False,
                                         softcap=softcap, impl=impl))
    elif cache is not None and "k_pages" in cache:
        if s != 1:
            raise ValueError("a paged cache takes single-token decode")
        ps = cache["k_pages"].shape[1]
        bt = cache["block_table"]
        capacity = bt.shape[1] * ps
        cpos = torch.as_tensor(cache_pos, device=x.device).expand(b)
        page_idx = torch.clamp(cpos // ps, max=bt.shape[1] - 1)
        rows = torch.arange(b, device=x.device)
        page_ids = torch.where(cpos < capacity, bt[rows, page_idx].long(),
                               torch.zeros_like(page_idx)).long()
        slot_in_page = (cpos % ps).long()
        if "k_scale" in cache:  # int8 pages: requantising append
            _paged_token_write_quant(cache["k_pages"], cache["k_scale"],
                                     page_ids, slot_in_page, k[:, 0])
            _paged_token_write_quant(cache["v_pages"], cache["v_scale"],
                                     page_ids, slot_in_page, v[:, 0])
        else:
            idx = page_ids * ps + slot_in_page
            _flat_row_write(cache["k_pages"], idx, k[:, 0])
            _flat_row_write(cache["v_pages"], idx, v[:, 0])
        if return_cache:
            new_cache = cache
        if kv_len is None:
            kv_len = torch.clamp(cpos + 1, max=capacity)
        out = kops.paged_decode_attention(
            q[:, 0], cache["k_pages"], cache["v_pages"], bt,
            kv_len.to(torch.int32), k_scale=cache.get("k_scale"),
            v_scale=cache.get("v_scale"), softcap=softcap,
            impl=impl)[:, None]
    elif cache is not None:
        ck, cv = cache["k"], cache["v"]
        length = ck.shape[1]
        cpos = torch.as_tensor(cache_pos, device=x.device).long()
        if s > 1:
            # suffix prefill: S rows from one scalar position, which never
            # wraps.  The start is clamped to length - S, as the reference's
            # dynamic_update_slice clamps; prefill_into_slot refuses a
            # suffix that would need it
            if cpos.ndim or s > length:
                raise ValueError("a multi-token cache write takes one scalar "
                                 f"cache_pos and at most {length} tokens")
            rows = (torch.clamp(cpos, max=length - s)
                    + torch.arange(s, device=x.device))
            ck.index_copy_(1, rows, k.to(ck.dtype))
            cv.index_copy_(1, rows, v.to(cv.dtype))
        else:
            cpos = cpos.expand(b)
            # a position past the stripe is a dropped write (its row keeps
            # its value), never an alias into the next slot's stripe
            ok = (cpos < length)[:, None, None]
            idx = (torch.arange(b, device=x.device) * length
                   + torch.clamp(cpos, max=length - 1))
            for buf, tok in ((ck, k[:, 0]), (cv, v[:, 0])):
                old = buf.view((-1,) + tuple(buf.shape[2:]))[idx]
                _flat_row_write(buf, idx,
                                torch.where(ok, tok.to(buf.dtype), old))
        if return_cache:
            new_cache = cache
        if kv_len is None:
            kv_len = torch.clamp(cpos + s, max=length)
        # one token: no causal or window mask, the ring's kv_len is the
        # window; S tokens: causal within the chunk, at their absolute
        # positions.
        # This is the reference's jnp form for both (no kernel on either
        # side): the suffix's queries read the cached prefix through it
        out = naive_attention(q, ck, cv, causal=s > 1,
                              q_offset=cpos if s > 1 else 0, kv_len=kv_len,
                              softcap=softcap,
                              reduce_dtype=policy.reduce_dtype)
    else:
        sq, skv = q.shape[1], k.shape[1]
        if sq * skv > 512 * 512:
            out = chunked_attention(q, k, v, causal=True, window=window,
                                    softcap=softcap, impl=impl)
        else:
            out = naive_attention(q, k, v, causal=True, window=window,
                                  softcap=softcap,
                                  reduce_dtype=policy.reduce_dtype)
        if return_cache:
            new_cache = {"k": k, "v": v}

    out = out.to(cdt).reshape(b * s, h * dh)
    y = out @ params["wo"].to(cdt).reshape(h * dh, d)
    return y.reshape(b, s, d), new_cache


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                         dtype=torch.bfloat16, device="cpu") -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Paged KV cache: global page pool + per-slot block tables
# ---------------------------------------------------------------------------

def init_paged_attention_cache(cfg: ModelConfig, batch: int, num_pages: int,
                               page_size: int, max_pages: int,
                               dtype=torch.bfloat16, quantized: bool = False,
                               device="cpu",
                               block_table: Optional[torch.Tensor] = None
                               ) -> dict:
    """Page pool ``k_pages``/``v_pages`` (P, page_size, KV, Dh) plus the
    per-slot ``block_table`` (B, max_pages) int32, all entries starting at
    the trash page 0.  ``quantized`` stores int8 pages with per-(page,
    kv-head) fp32 scales.  ``block_table`` may be passed in so that every
    layer shares one table (one logical allocation per slot)."""
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    store = torch.int8 if quantized else dtype
    shape = (num_pages, page_size, kv, dh)
    if block_table is None:
        block_table = torch.zeros((batch, max_pages), dtype=torch.int32,
                                  device=device)
    cache = {
        "k_pages": torch.zeros(shape, dtype=store, device=device),
        "v_pages": torch.zeros(shape, dtype=store, device=device),
        "block_table": block_table,
    }
    if quantized:
        cache["k_scale"] = torch.zeros((num_pages, kv), dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros((num_pages, kv), dtype=torch.float32,
                                       device=device)
    return cache


def quantize_pages(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, page_size, KV, Dh) float -> (int8 pages, (N, KV) scales).
    Symmetric per-(page, kv-head): scale = amax / 127; ``torch.round``
    rounds half to even, as ``jnp.round``."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=(1, 3))                            # (N, KV)
    scale = amax / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-20)[:, None, :, None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _flat_row_write(buf: torch.Tensor, row_idx: torch.Tensor,
                    tok: torch.Tensor) -> None:
    """In place: buf's first two dims collapsed, rows ``row_idx`` <- tok."""
    flat = buf.view((-1,) + tuple(buf.shape[2:]))
    flat[row_idx] = tok.to(buf.dtype)


def _paged_token_write_quant(pages, scales, page_ids, slot_in_page,
                             token) -> None:
    """Append one token per slot into its int8 page, in place.  When the
    token's amax exceeds the page's scale the resident ints are requantised
    to the grown scale; a write at page slot 0 restarts the scale from this
    token (a recycled page must not keep its previous tenant's scale)."""
    b = token.shape[0]
    tf = token.to(torch.float32)                                # (B, KV, Dh)
    amax = tf.abs().amax(dim=-1)                                # (B, KV)
    old = scales[page_ids]
    fresh = (slot_in_page == 0)[:, None]
    new = torch.where(fresh, amax / 127.0, torch.maximum(old, amax / 127.0))
    ratio = torch.where(new > 0, old / torch.clamp(new, min=1e-20),
                        torch.zeros_like(new))
    page = pages[page_ids].to(torch.float32)                    # (B,ps,KV,Dh)
    page = torch.round(page * ratio[:, None, :, None])
    qtok = torch.round(tf / torch.clamp(new, min=1e-20)[..., None])
    page[torch.arange(b, device=page.device), slot_in_page] = qtok
    pages[page_ids] = torch.clamp(page, -127, 127).to(torch.int8)
    scales[page_ids] = new


def valid_token_mask(valid_len, batch: int, s: int, device=None):
    """(B, S) bool mask of true-prompt positions of a right-padded prefill;
    None for full-width prompts."""
    if valid_len is None:
        return None
    vl = torch.as_tensor(valid_len, device=device).to(torch.int32)
    vl = vl.reshape(-1).expand(batch)
    return torch.arange(s, device=vl.device)[None, :] < vl[:, None]


def paged_prefill_write(pcache: dict, k: torch.Tensor, v: torch.Tensor,
                        valid_len=None) -> dict:
    """Write prefill KV (B, S, KV, Dh) into the page pool through each row's
    block table, in place.  S is padded to whole pages; KV past a row's
    ``valid_len`` is zeroed first (dead at read time, but it would inflate
    an int8 page's amax).  Unallocated table entries point at the trash
    page."""
    ps = pcache["k_pages"].shape[1]
    mp = pcache["block_table"].shape[1]
    b, s = k.shape[:2]
    keep = valid_token_mask(valid_len, b, s, k.device)
    if keep is not None:
        k = torch.where(keep[..., None, None], k, torch.zeros_like(k))
        v = torch.where(keep[..., None, None], v, torch.zeros_like(v))
    n = -(-s // ps)
    if n > mp:
        raise ValueError(f"prefill width {s} exceeds paged capacity {mp * ps}")
    pad = n * ps - s
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kr = k.reshape(b * n, ps, *k.shape[2:])
    vr = v.reshape(b * n, ps, *v.shape[2:])
    pids = pcache["block_table"][:, :n].reshape(-1).long()
    if "k_scale" in pcache:
        qk, sk = quantize_pages(kr)
        qv, sv = quantize_pages(vr)
        pcache["k_pages"][pids] = qk
        pcache["v_pages"][pids] = qv
        pcache["k_scale"][pids] = sk
        pcache["v_scale"][pids] = sv
    else:
        dt = pcache["k_pages"].dtype
        pcache["k_pages"][pids] = kr.to(dt)
        pcache["v_pages"][pids] = vr.to(dt)
    return pcache


def copy_page_cow(pcache: dict, src, dst, valid) -> dict:
    """Copy-on-write: duplicate page ``src`` into ``dst`` of one layer's
    pool, in place, so a slot can append privately while siblings still
    read ``src``.  Only the first ``valid`` rows (the copying slot's tokens
    in that page) are kept; the rest are zeroed.  An int8 copy restarts its
    scale: the source is dequantised at its own scale, the dead rows
    zeroed, and the page requantised fresh (``quantize_pages``), so a
    sibling's larger appends never coarsen the copy."""
    ps = pcache["k_pages"].shape[1]
    dev = pcache["k_pages"].device
    keep = (torch.arange(ps, device=dev) < torch.as_tensor(valid, device=dev)
            )[:, None, None]
    if "k_scale" in pcache:
        for pk, sk in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
            page = (pcache[pk][src].to(torch.float32)
                    * pcache[sk][src][None, :, None])
            q, sc = quantize_pages(
                torch.where(keep, page, torch.zeros_like(page))[None])
            pcache[pk][dst] = q[0]
            pcache[sk][dst] = sc[0]
    else:
        for pk in ("k_pages", "v_pages"):
            page = pcache[pk][src]
            pcache[pk][dst] = torch.where(keep, page, torch.zeros_like(page))
    return pcache


# ---------------------------------------------------------------------------
# MLP and embeddings
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, generator: torch.Generator, *,
             dtype=torch.float32, device="cpu") -> Params:
    d, f = cfg.d_model, cfg.d_ff
    std_o = 0.02 / math.sqrt(2 * cfg.n_layers)
    kw = dict(generator=generator, dtype=dtype, device=device)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {"wi": trunc_normal((d, f), **kw),
                "wg": trunc_normal((d, f), **kw),
                "wo": trunc_normal((f, d), stddev=std_o, **kw)}
    if cfg.mlp_kind == "gelu":   # BERT: biases included
        return {"wi": trunc_normal((d, f), **kw),
                "bi": torch.zeros((f,), dtype=dtype, device=device),
                "wo": trunc_normal((f, d), stddev=std_o, **kw),
                "bo": torch.zeros((d,), dtype=dtype, device=device)}
    raise NotImplementedError(f"{cfg.mlp_kind} MLPs: the port runs swiglu, "
                              "geglu and gelu")


def apply_mlp(params: Params, x: torch.Tensor, cfg: ModelConfig,
              policy: Policy, *, impl: Optional[str] = None) -> torch.Tensor:
    """SwiGLU: (silu(x wg) * (x wi)) wo.  GeGLU (gemma2): the same with the
    tanh-GELU in place of silu, elementwise in PyTorch as the reference's
    is in jnp (no kernel on either side).  GELU (BERT): the up-projection's
    bias and the tanh-GELU in one kernel, gelu(x wi + bi) wo + bo.  All in
    the compute dtype."""
    cdt = policy.compute_dtype
    xc = x.to(cdt)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        hi = xc @ params["wi"].to(cdt)
        hg = xc @ params["wg"].to(cdt)
        act = (F.silu(hg) if cfg.mlp_kind == "swiglu"
               else F.gelu(hg, approximate="tanh"))
        return (act * hi) @ params["wo"].to(cdt)
    if cfg.mlp_kind == "gelu":
        h = kops.bias_gelu(xc @ params["wi"].to(cdt), params["bi"].to(cdt),
                           impl=impl)
        return h @ params["wo"].to(cdt) + params["bo"].to(cdt)
    raise NotImplementedError(f"{cfg.mlp_kind} MLPs: the port runs swiglu, "
                              "geglu and gelu")


def init_embedding(cfg: ModelConfig, generator: torch.Generator, *,
                   dtype=torch.float32, device="cpu") -> Params:
    kw = dict(generator=generator, dtype=dtype, device=device)
    params = {"tok": trunc_normal((cfg.vocab_size, cfg.d_model), **kw)}
    if cfg.pos_kind == "learned":
        if cfg.max_position <= 0:
            raise ValueError("learned positions need max_position > 0")
        params["pos"] = trunc_normal((cfg.max_position, cfg.d_model), **kw)
    return params


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 policy: Policy, *, pos_offset=0) -> torch.Tensor:
    """Token embedding in the compute dtype, times sqrt(d_model) rounded
    to the compute dtype first (``cfg.scale_embeddings``, gemma2: 67.88 is
    68.0 in bf16, as in the reference), plus the learned position
    embedding (``cfg.pos_kind == "learned"``) of positions ``pos_offset``
    .. ``pos_offset`` + S - 1: ``pos_offset`` a Python int (a slice of the
    table: training and prefill take 0), a 0-d tensor, or a (B,) tensor
    giving each batch row its own offset (continuous-batching decode, each
    slot at its own position)."""
    x = F.embedding(tokens.long(), params["tok"]).to(policy.compute_dtype)
    if cfg.scale_embeddings:
        # the scale rounded on the host (a Python float of its bits): a
        # Python float times a bf16 tensor would keep the scale unrounded
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    if cfg.pos_kind == "learned":
        s = tokens.shape[-1]
        if isinstance(pos_offset, int):
            pos = params["pos"][pos_offset:pos_offset + s]
        else:
            off = torch.as_tensor(pos_offset, device=x.device).long()
            ids = torch.arange(s, device=x.device)
            # 0-d -> (S,); (B,) -> (B, S); both broadcast against (B, S, d)
            pos = params["pos"][(off[:, None] if off.ndim else off) + ids]
        x = x + pos.to(x.dtype)
    return x
