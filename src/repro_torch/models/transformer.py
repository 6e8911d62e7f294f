"""Decoder LM and encoder-decoder (port of ``repro/models/transformer.py``
for attention layers -- full, sliding-window local and global, with or
without query/key norms -- and mamba layers, each under a dense or a
Mixture-of-Experts MLP, RWKV-6 layers, and whisper's bidirectional
encoder with cross-attention in every decoder layer).

The reference stacks the blocks' weights on a leading axis and runs them
with ``lax.scan``; here each layer is its own dict of tensors in a list and
a Python loop runs them in the same order (block-major, then position in
``block_pattern``), which is the order ``bridge.params_from_jax`` unstacks.

Parameters are a plain dict::

    {"embed": {"tok": (V, d)}, "blocks": [layer, ...],
     "final_norm": {"scale"[, "bias"]}[, "lm_head": (d, V)]}
    attention layer = {"norm1", "mixer": {"wq" (d,H,Dh), "wk", "wv",
                       "wo" (H,Dh,d)[, "bq" (H,Dh), "bk", "bv" (KV,Dh)]
                       [, "q_norm" (Dh,), "k_norm"]}
                       [, "postnorm1"], "norm2", "mlp": {"wi", "wg", "wo"}
                       [, "postnorm2"]}
    mamba layer's mixer = {"in_proj" (d, 2 din), "conv_w" (dc, din),
                           "conv_b", "x_proj" (din, r + 2 N), "dt_proj"
                           (r, din), "dt_bias", "a_log" (din, N), "d_skip",
                           "out_proj" (din, d)}  (``models/mamba.py``)
    MoE layer's mlp = {"router" (d,E), "wi", "wg" (E,d,f), "wo" (E,f,d)}
                      (``models/moe.py``)
    rwkv layer = {"norm1", "mixer": time mix, "norm2", "mlp": channel mix}
                 (``models/rwkv.py``; norms are LayerNorms with a bias)
    encoder-decoder (whisper): every decoder layer adds {"norm_cross",
        "cross": {"wq", "wk", "wv", "wo"}}, and the model {"enc_blocks":
        [layer, ...] (bidirectional attention, ``cfg.enc_block_pattern``),
        "enc_norm", "enc_pos" (enc_seq, d)}

A tied model (``cfg.tie_embeddings``, gemma2) has no ``lm_head``: the
logits are taken against ``embed.tok`` transposed.  ``cfg.post_block_norm``
(gemma2) norms each sublayer's output before its residual add.  An MoE
layer's MLP is ``moe.moe_apply`` with the caller's ``moe_impl``: the
defaults are the reference's (``apply_lm`` and ``prefill`` "a2a",
``prefill_suffix`` "dense", ``decode_step`` "replicated"; on one device
"a2a" and "replicated" are the capacity path), and the serving stack
passes "dense".  The router's aux loss is the reference's: its scan over
blocks keeps, of each block, the aux of the block's last pattern position
(0 where that position's MLP is dense) and sums those over the blocks, so
jamba's 8-position block counts position 7's MoE layer and not those at 1,
3 and 5; ``apply_lm(return_aux=True)`` returns it.

The decode state is ``{"pos": (B,) int32, "blocks": [layer state, ...]}``
with ``{"cache": ...}`` for an attention layer (and an encoder-decoder's
``"cross": {"k", "v"}`` (B, enc_len, KV, Dh), contiguous whatever the
self-attention cache: a prefill writes the encoder's K and V there, a
decode step reads them), ``{"conv", "ssm"}`` (fp32)
for a mamba layer and ``{"tm_shift", "wkv", "cm_shift"}`` (fp32) for an
rwkv layer.  A local (sliding-window) layer's
contiguous cache is a ring of ``min(max_len, sliding_window)`` rows: decode
writes position p at row p % rows, and a prefill wider than the ring keeps
its last rows there, rolled to the same place.  ``prefill`` and
``decode_step`` update it in place and return the same dict.  In a paged
state every attention layer's cache holds the same ``block_table``
tensor: one logical allocation per slot serves all of them (the reference
keeps one stacked copy per block); a hybrid's mamba layers keep their
per-slot rows beside the pool, outside the table.

An encoder-decoder (whisper-small) runs its encoder over the request's
frame embeddings plus ``enc_pos`` and ``enc_norm`` (``_encode``) in
``apply_lm`` and ``prefill``; each decoder layer's cross sublayer sits
between its self-attention and its MLP, over the encoder's output or, in
a decode step, the cross cache; learned decoder positions are embedded at
each slot's own ``state["pos"]`` in a decode step.

A vision-language model (qwen2-vl) rotates its queries and keys by M-RoPE
over (3, B, S) position triples (``layers.apply_mrope``): ``apply_lm``
and ``prefill`` take ``positions`` (3, B, S), by default ``arange(S)`` on
all three axes, and a decode step or a suffix prefill broadcasts its
slots' positions to the three axes, as the reference does.  Its vision
tower is a stub: ``vision_embeds`` (B, Nv, d) overwrite the embeddings of
the first Nv positions, cast to the compute dtype; a prompt shorter than
Nv raises ``ValueError``.  Without them a vision model runs on its
tokens alone (the serving stack's slots are text-only, as the
reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RW

LAYER_KINDS = (("attn", "dense"), ("attn_local", "dense"),
               ("attn_global", "dense"), ("attn", "moe"),
               ("mamba", "dense"), ("mamba", "moe"), ("rwkv", "rwkv_cm"))
ENC_LAYER_KINDS = (("attn_bidir", "dense"),)


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Geometry of a paged KV cache: ``num_pages`` counts the pool including
    the trash page 0; per-slot capacity is ``ceil(max_len / page_size)``
    table entries.  ``quantized`` stores int8 pages with per-(page,
    kv-head) scales."""
    page_size: int
    num_pages: int
    quantized: bool = False


def check_supported(cfg: ModelConfig) -> None:
    """Raise for architecture features the port does not run yet."""
    for kind in cfg.block_pattern:
        if tuple(kind) not in LAYER_KINDS:
            raise NotImplementedError(
                f"{kind} layers: the port runs {LAYER_KINDS}")
    if cfg.is_encoder_only:
        raise NotImplementedError("encoder-only models are BERT "
                                  "(models/bert.py)")
    if cfg.is_encoder_decoder:
        for kind in cfg.enc_block_pattern:
            if tuple(kind) not in ENC_LAYER_KINDS:
                raise NotImplementedError(
                    f"{kind} encoder layers: the port runs "
                    f"{ENC_LAYER_KINDS}")


def enc_layer_kinds(cfg: ModelConfig):
    """The encoder's (mixer, mlp) per layer, ``n_enc_layers`` of them."""
    pattern = tuple(cfg.enc_block_pattern)
    return pattern * (cfg.n_enc_layers // len(pattern))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, *, seed: int = 0, dtype=torch.float32,
               device="cuda") -> dict:
    """Seeded random weights, drawn on ``device`` and stored in ``dtype``
    (the policy's ``param_dtype``).  Distributions follow the reference's
    init (truncated normal, std 0.02, output projections scaled by
    1/sqrt(2 n_layers)); the values differ, since ``torch.Generator`` is not
    ``jax.random``."""
    check_supported(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(dtype=dtype, device=device)
    params = {"embed": L.init_embedding(cfg, gen, **kw), "blocks": []}
    for mixer, mlp_kind in cfg.layer_kinds():
        if mixer == "rwkv":
            mix, mlp = (RW.init_time_mix(cfg, gen, **kw),
                        RW.init_channel_mix(cfg, gen, **kw))
        else:
            mix = (MB.init_mamba if mixer == "mamba"
                   else L.init_attention)(cfg, gen, **kw)
            mlp = (MOE.init_moe if mlp_kind == "moe"
                   else L.init_mlp)(cfg, gen, **kw)
        layer = {"norm1": L.init_norm(cfg, **kw), "mixer": mix,
                 "norm2": L.init_norm(cfg, **kw), "mlp": mlp}
        if cfg.post_block_norm:
            layer.update(postnorm1=L.init_norm(cfg, **kw),
                         postnorm2=L.init_norm(cfg, **kw))
        if cfg.is_encoder_decoder:
            layer.update(norm_cross=L.init_norm(cfg, **kw),
                         cross=L.init_attention(cfg, gen, **kw))
        params["blocks"].append(layer)
    params["final_norm"] = L.init_norm(cfg, **kw)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.trunc_normal((cfg.d_model, cfg.vocab_size),
                                           gen, **kw)
    if cfg.is_encoder_decoder:
        params["enc_blocks"] = [
            {"norm1": L.init_norm(cfg, **kw),
             "mixer": L.init_attention(cfg, gen, **kw),
             "norm2": L.init_norm(cfg, **kw),
             "mlp": L.init_mlp(cfg, gen, **kw)}
            for _ in enc_layer_kinds(cfg)]
        params["enc_norm"] = L.init_norm(cfg, **kw)
        params["enc_pos"] = L.trunc_normal((cfg.enc_seq, cfg.d_model), gen,
                                           **kw)
    return params


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16,
                      paged: Optional[PagedCacheConfig] = None,
                      device="cuda", enc_len: int = 0) -> dict:
    """Per-layer decode state with per-slot positions ``pos`` (B,).
    ``enc_len`` > 0 (an encoder-decoder) adds each attention layer's
    contiguous cross cache {"k", "v"} (B, enc_len, KV, Dh) in
    ``cache_dtype``, beside a contiguous or a paged self-attention cache.
    ``paged`` replaces each slot's contiguous (max_len, KV, Dh) stripe with
    the global page pool and one block table shared by all layers; a
    sliding-window ring cannot be paged and raises ``ValueError``.  A local
    layer's contiguous cache is a ring of ``min(max_len,
    cfg.sliding_window)`` rows.  A mamba or an rwkv layer holds its fp32
    recurrent rows and no cache (``max_len``, ``cache_dtype`` and
    ``paged`` do not apply to it): a hybrid's paged state has the pool and
    the table in its attention layers only."""
    check_supported(cfg)
    blocks = []
    table = None
    if paged is not None:
        max_pages = -(-max_len // paged.page_size)
        table = torch.zeros((batch, max_pages), dtype=torch.int32,
                            device=device)
    for mixer, _ in cfg.layer_kinds():
        if mixer == "rwkv":
            blocks.append(RW.init_rwkv_state(cfg, batch, device=device))
            continue
        if mixer == "mamba":
            blocks.append(MB.init_mamba_state(cfg, batch, device=device))
            continue
        if paged is not None:
            if mixer != "attn":
                raise ValueError(f"paged KV cache: {mixer} layers (a "
                                 "sliding-window model's) cannot be paged")
            cache = L.init_paged_attention_cache(
                cfg, batch, paged.num_pages, paged.page_size,
                table.shape[1], dtype=cache_dtype, quantized=paged.quantized,
                device=device, block_table=table)
        else:
            rows = max_len
            if mixer == "attn_local" and cfg.sliding_window:
                rows = min(max_len, cfg.sliding_window)
            cache = L.init_attention_cache(cfg, batch, rows, cache_dtype,
                                           device=device)
        blocks.append({"cache": cache})
        if enc_len:
            blocks[-1]["cross"] = L.init_attention_cache(
                cfg, batch, enc_len, cache_dtype, device=device)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "blocks": blocks}


def set_block_tables(state: dict, rows, slot: Optional[int] = None) -> dict:
    """Write page-id rows into the block table, in place: ``rows``
    (B, max_pages) for the whole batch or (max_pages,) for one ``slot``."""
    seen = set()
    for st in state["blocks"]:
        bt = st.get("cache", {}).get("block_table")
        if bt is None or id(bt) in seen:
            continue
        seen.add(id(bt))
        r = torch.as_tensor(rows, dtype=torch.int32).to(bt.device)
        if slot is None:
            bt.copy_(r.expand(bt.shape))
        else:
            bt[slot] = r
    return state


# ---------------------------------------------------------------------------
# Per-layer apply
# ---------------------------------------------------------------------------

def _decode_positions(decode_pos: torch.Tensor, batch: int, s: int,
                      cfg: ModelConfig) -> torch.Tensor:
    """Absolute positions (B, S) of ``s`` tokens from ``decode_pos``, a
    scalar (the suffix prefill) or per slot (B,) (decode); under M-RoPE
    the same on all three axes, (3, B, S)."""
    p = decode_pos.long().reshape(-1, 1)
    p = (p + torch.arange(s, device=p.device)[None]).expand(batch, s)
    return p[None].expand(3, batch, s) if cfg.pos_kind == "mrope" else p


def _embed(params, tokens, cfg: ModelConfig, policy: Policy,
           vision_embeds=None, positions=None):
    """The token embedding with a vision model's stub patch embeddings
    (B, Nv, d) over its first Nv positions, cast to the compute dtype,
    and the rotary positions: the caller's, or under M-RoPE ``arange(S)``
    on all three axes (None under RoPE: ``apply_attention`` makes its
    own).  Returns (x, positions)."""
    x = L.embed_tokens(params["embed"], tokens, cfg, policy)
    if vision_embeds is not None and cfg.n_vision_tokens:
        nv = vision_embeds.shape[1]
        if tokens.shape[1] < nv:
            raise ValueError(f"{cfg.arch_id}: a prompt of {tokens.shape[1]} "
                             f"tokens cannot hold {nv} vision embeddings")
        x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
    if positions is None and cfg.pos_kind == "mrope":
        b, s = tokens.shape
        positions = torch.arange(s, device=x.device)[None, None].expand(
            3, b, s)
    return x, positions


def _fit_cache(new_cache: dict, state: dict, valid_len=None) -> None:
    """Write a prefill's contiguous K/V (B, S, KV, Dh) into the layer's
    allocated cache, in place: through the block table for a paged cache,
    else into the first S rows of each stripe (rows past S are zeroed, as
    the reference pads).  A prefill wider than a ring of ``tgt`` rows keeps
    its last ``tgt`` positions, rolled by ``S % tgt`` so that position p
    sits at row p % tgt, where decode writes it."""
    cache = state["cache"]
    if "k_pages" in cache:
        L.paged_prefill_write(cache, new_cache["k"], new_cache["v"],
                              valid_len=valid_len)
        return
    s, tgt = new_cache["k"].shape[1], cache["k"].shape[1]
    for key in ("k", "v"):
        if s > tgt:
            cache[key].copy_(torch.roll(new_cache[key][:, -tgt:],
                                        shifts=s % tgt, dims=1))
        else:
            cache[key][:, :s] = new_cache[key]
            cache[key][:, s:] = 0


def _apply_rwkv_layer(p, x, cfg: ModelConfig, policy: Policy, *,
                      state=None, valid_len=None,
                      impl: Optional[str] = None):
    """Time mix and channel mix, each behind a LayerNorm; with a state the
    recurrent rows are read and then overwritten in place."""
    h = L.apply_norm(p["norm1"], x, cfg, policy, impl=impl)
    y, ns = RW.apply_time_mix(p["mixer"], h, cfg, policy, state=state,
                              return_state=state is not None,
                              valid_len=valid_len, impl=impl)
    x = x + y.to(x.dtype)
    h = L.apply_norm(p["norm2"], x, cfg, policy, impl=impl)
    y2, ns2 = RW.apply_channel_mix(p["mlp"], h, cfg, policy, state=state,
                                   return_state=state is not None,
                                   valid_len=valid_len)
    if state is not None:
        for key, t in {**ns, **ns2}.items():
            state[key].copy_(t)
    return x + y2.to(x.dtype)


def _apply_mamba_mixer(p, h, cfg: ModelConfig, policy: Policy, *,
                       state=None, valid_len=None):
    """A mamba mixer; with a state its ``conv`` and ``ssm`` rows are read
    and then overwritten in place.  Decode passes no ``valid_len``."""
    y, ns = MB.apply_mamba(p, h, cfg, policy, state=state,
                           return_state=state is not None,
                           valid_len=valid_len)
    if state is not None:
        for key, t in ns.items():
            state[key].copy_(t)
    return y


def _apply_cross(p, x, cfg: ModelConfig, policy: Policy, *, enc_out=None,
                 state=None, impl: Optional[str] = None):
    """The cross sublayer of an encoder-decoder's decoder layer: its norm,
    then attention over the encoder's output ``enc_out`` (a prefill or a
    training step; a prefill writes the K and V it projects into the
    state's cross cache, in place: ``init_decode_state(enc_len=)``) or,
    without it, over the state's cross cache (a decode step, which never
    writes it).  Returns x with the sublayer's output added."""
    h = L.apply_norm(p["norm_cross"], x, cfg, policy, impl=impl)
    ccache = state.get("cross") if state is not None else None
    keep = state is not None and enc_out is not None
    if keep and ccache is None:
        raise ValueError("a prefill of an encoder-decoder needs the state's "
                         "cross caches: init_decode_state(enc_len=enc_seq)")
    y, nc = L.apply_attention(p["cross"], h, cfg, policy, kv_source=enc_out,
                              cache=ccache, static_kv=True,
                              return_cache=keep)
    if keep:
        ccache["k"].copy_(nc["k"])
        ccache["v"].copy_(nc["v"])
    return x + y.to(x.dtype)


def _apply_layer(p, x, cfg: ModelConfig, policy: Policy, mixer: str,
                 mlp: str, *, state=None, decode_pos=None, valid_len=None,
                 positions=None, enc_out=None, moe_impl: str = "a2a",
                 impl: Optional[str] = None):
    """One layer; returns (x, the MoE router's aux loss or None).  An
    encoder-decoder's decoder layer (``"cross" in p``) runs its cross
    sublayer (``_apply_cross``) between the mixer and the MLP.
    ``positions`` rotate a prompt's queries and keys (RoPE (B, S), M-RoPE
    (3, B, S)); with ``decode_pos`` they are the caller's or the slots'
    own (``_decode_positions``), as the reference's."""
    if mixer == "rwkv":
        return _apply_rwkv_layer(p, x, cfg, policy, state=state,
                                 valid_len=valid_len, impl=impl), None
    def post(y, which):   # gemma2's norm of a sublayer's output
        if cfg.post_block_norm:
            return L.apply_norm(p[which], y, cfg, policy, impl=impl)
        return y

    h = L.apply_norm(p["norm1"], x, cfg, policy, impl=impl)
    cache = state.get("cache") if state is not None else None
    if mixer == "mamba":
        y = _apply_mamba_mixer(p["mixer"], h, cfg, policy, state=state,
                               valid_len=valid_len)
    elif cache is not None and decode_pos is not None:
        if "k_pages" in cache:
            # no ring wrap: a paged write past capacity is routed to the
            # trash page inside apply_attention
            cache_len = cache["block_table"].shape[-1] * cache["k_pages"].shape[1]
            write_pos = decode_pos
        else:
            cache_len = cache["k"].shape[1]
            write_pos = torch.remainder(decode_pos, cache_len)
        kv_len = torch.clamp(decode_pos + h.shape[1], max=cache_len)
        # "attn" whatever the layer: a ring's kv_len is its window
        y, _ = L.apply_attention(
            p["mixer"], h, cfg, policy,
            positions=positions if positions is not None else
            _decode_positions(decode_pos, h.shape[0], h.shape[1], cfg),
            cache=cache,
            cache_pos=write_pos, kv_len=kv_len, impl=impl)
    else:
        y, nc = L.apply_attention(p["mixer"], h, cfg, policy,
                                  mixer_kind=mixer, positions=positions,
                                  return_cache=state is not None, impl=impl)
        if state is not None:
            _fit_cache(nc, state, valid_len)
    x = x + post(y, "postnorm1").to(x.dtype)
    if "cross" in p:
        x = _apply_cross(p, x, cfg, policy, enc_out=enc_out, state=state,
                         impl=impl)
    h = L.apply_norm(p["norm2"], x, cfg, policy, impl=impl)
    aux = None
    if mlp == "moe":
        y, aux = MOE.moe_apply(p["mlp"], h, cfg, policy, impl=moe_impl)
    else:
        y = L.apply_mlp(p["mlp"], h, cfg, policy, impl=impl)
    return x + post(y, "postnorm2").to(x.dtype), aux


def _lm_logits(params, x, cfg: ModelConfig, policy: Policy):
    """Logits against ``lm_head``, or the token table transposed where the
    embeddings are tied; the final softcap in the reduce dtype."""
    cdt = policy.compute_dtype
    head = params.get("lm_head")
    if head is None:
        head = params["embed"]["tok"].T
    logits = x.to(cdt) @ head.to(cdt)
    if cfg.final_logit_softcap:
        logits = L._soft_cap(logits.to(policy.reduce_dtype),
                             cfg.final_logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _encode(params, enc_frames, cfg: ModelConfig, policy: Policy, *,
            remat: bool = False, impl: Optional[str] = None):
    """An encoder-decoder's encoder: the frame embeddings (B, enc_seq, d)
    plus ``enc_pos``, in the compute dtype, through the encoder layers
    (bidirectional attention, each recomputed in the backward under
    ``remat``) and ``enc_norm``.  Returns the encoder's output, the K and
    V source of every cross sublayer."""
    if enc_frames is None:
        raise ValueError(f"{cfg.arch_id} is an encoder-decoder: it needs "
                         "enc_frames (B, enc_seq, d_model)")
    cdt = policy.compute_dtype
    e = enc_frames.to(cdt) + params["enc_pos"].to(cdt)[None]
    for p, (mixer, mlp) in zip(params["enc_blocks"], enc_layer_kinds(cfg)):
        if remat:
            e, _ = checkpoint(_apply_layer, p, e, cfg, policy, mixer, mlp,
                              impl=impl, use_reentrant=False)
        else:
            e, _ = _apply_layer(p, e, cfg, policy, mixer, mlp, impl=impl)
    return L.apply_norm(params["enc_norm"], e, cfg, policy, impl=impl)


def apply_lm(params, tokens, cfg: ModelConfig, policy: Policy, *,
             positions=None, vision_embeds=None, enc_frames=None,
             remat: bool = False, moe_impl: str = "a2a",
             return_aux: bool = False, impl: Optional[str] = None):
    """Full forward of (B, S) tokens -> logits (B, S, V), for training and
    scoring; with ``return_aux`` (logits, aux), aux the MoE router's loss
    as the reference's ``_run_blocks`` carries it (0-d fp32; 0 for a model
    without MoE layers, which the reference always returns): per block of
    ``len(cfg.block_pattern)`` layers the aux of its last position only,
    summed over the blocks in order.  ``remat=True`` recomputes each
    layer in the backward pass (``torch.utils.checkpoint``, non-reentrant),
    as ``jax.checkpoint`` wraps the reference's scan body (one block: one
    layer of a one-position ``block_pattern``).  The checkpointed layer
    returns its aux loss beside x; the aux of any other position is
    dropped after it returns, so the aux loss's gradient reaches through
    the recompute exactly the routers the reference's reaches, those of
    each block's last position.  The recompute runs the forward's
    operations on the same inputs, each deterministic (``models/moe.py``),
    so it routes and dispatches every token as the forward did.  An
    encoder-decoder takes ``enc_frames`` (B, enc_seq, d) and runs the
    encoder first (``_encode``, its layers recomputed too under
    ``remat``).  A vision model's ``vision_embeds`` (B, Nv, d) overwrite
    its first Nv embeddings; ``positions`` (3, B, S) are its M-RoPE
    triples, by default ``arange(S)`` on each axis (``_embed``)."""
    x, positions = _embed(params, tokens, cfg, policy, vision_embeds,
                          positions)
    enc_out = (_encode(params, enc_frames, cfg, policy, remat=remat,
                       impl=impl) if cfg.is_encoder_decoder else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    last = len(cfg.block_pattern) - 1
    for i, (p, (mixer, mlp)) in enumerate(zip(params["blocks"],
                                              cfg.layer_kinds())):
        if remat:
            x, a = checkpoint(_apply_layer, p, x, cfg, policy, mixer, mlp,
                              positions=positions, enc_out=enc_out,
                              moe_impl=moe_impl, impl=impl,
                              use_reentrant=False)
        else:
            x, a = _apply_layer(p, x, cfg, policy, mixer, mlp,
                                positions=positions, enc_out=enc_out,
                                moe_impl=moe_impl, impl=impl)
        if a is not None and i % len(cfg.block_pattern) == last:
            aux = aux + a
    x = L.apply_norm(params["final_norm"], x, cfg, policy, impl=impl)
    logits = _lm_logits(params, x, cfg, policy)
    return (logits, aux) if return_aux else logits


def prefill(params, tokens, cfg: ModelConfig, policy: Policy, *, state,
            positions=None, vision_embeds=None, lengths=None,
            enc_frames=None, moe_impl: str = "a2a",
            impl: Optional[str] = None):
    """Run the prompt (B, S) through the model, filling ``state`` in place.
    Returns (last-token logits (B, V), state).  ``lengths`` (B,) are the
    true lengths of right-padded prompts: logits are taken at
    ``lengths - 1`` and decode resumes at ``lengths``; rwkv and mamba
    layers then run their masked sequential scans, without ``lengths``
    the chunked ones (``kops.wkv6``, ``mamba._ssm_chunked``).  An
    encoder-decoder runs its encoder over ``enc_frames`` (B, enc_seq, d)
    and fills each layer's cross cache from the encoder's output.  A
    vision model takes ``vision_embeds`` and ``positions`` as ``apply_lm``
    does; decode then resumes at ``lengths`` (or S) on all three axes."""
    x, positions = _embed(params, tokens, cfg, policy, vision_embeds,
                          positions)
    enc_out = (_encode(params, enc_frames, cfg, policy, impl=impl)
               if cfg.is_encoder_decoder else None)
    for p, st, (mixer, mlp) in zip(params["blocks"], state["blocks"],
                                   cfg.layer_kinds()):
        x, _ = _apply_layer(p, x, cfg, policy, mixer, mlp, state=st,
                            valid_len=lengths, positions=positions,
                            enc_out=enc_out, moe_impl=moe_impl, impl=impl)
    b, s = tokens.shape
    if lengths is None:
        x_last = x[:, -1:]
        new_pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    else:
        lengths = torch.as_tensor(lengths, device=x.device).to(torch.int32)
        x_last = x[torch.arange(b, device=x.device), lengths.long() - 1][:, None]
        new_pos = lengths
    x_last = L.apply_norm(params["final_norm"], x_last, cfg, policy,
                          impl=impl)
    logits = _lm_logits(params, x_last, cfg, policy)[:, 0]
    state["pos"].copy_(new_pos)
    return logits, state


def prefill_suffix(params, tokens, start, length, cfg: ModelConfig,
                   policy: Policy, *, state, moe_impl: str = "dense",
                   impl: Optional[str] = None):
    """Resume a prefill at position ``start``: run only the uncached suffix.

    ``tokens``: (B, P) right-padded suffix bucket; ``length``: its true
    length (scalar or (B,)); ``state``: a decode state with contiguous
    caches that already hold positions [0, start) (a prefix-cache hit).
    The suffix's K/V are written in place at [start, start + P), and each
    suffix query attends causally at its absolute position, RoPE included.
    Returns (logits at the last true suffix token (B, V), state), with
    ``pos`` at ``start + length``.  Attention-only architectures: pad tokens
    must not step a recurrent scan."""
    if any(not mixer.startswith("attn") for mixer, _ in cfg.layer_kinds()):
        raise ValueError("suffix prefill requires attention-only "
                         f"architectures, not {cfg.arch_id}")
    b = tokens.shape[0]
    dev = tokens.device
    pos0 = torch.as_tensor(start, device=dev).to(torch.int32).reshape(())
    x = L.embed_tokens(params["embed"], tokens, cfg, policy, pos_offset=pos0)
    for p, st, (mixer, mlp) in zip(params["blocks"], state["blocks"],
                                   cfg.layer_kinds()):
        x, _ = _apply_layer(p, x, cfg, policy, mixer, mlp, state=st,
                            decode_pos=pos0, moe_impl=moe_impl, impl=impl)
    lengths = torch.as_tensor(length, device=dev).to(torch.int32)
    lengths = lengths.reshape(-1).expand(b)
    x_last = x[torch.arange(b, device=dev), lengths.long() - 1][:, None]
    x_last = L.apply_norm(params["final_norm"], x_last, cfg, policy,
                          impl=impl)
    logits = _lm_logits(params, x_last, cfg, policy)[:, 0]
    state["pos"].copy_(pos0 + lengths)
    return logits, state


def copy_page(state: dict, src, dst, valid) -> dict:
    """Copy-on-write of page ``src`` into ``dst`` in every paged layer's
    pool, in place (``layers.copy_page_cow``: rows past ``valid`` zeroed, an
    int8 copy's scale restarted).  The block table is untouched: the
    scheduler repoints the diverging slot's row afterwards."""
    for st in state["blocks"]:
        cache = st.get("cache")
        if cache is not None and "k_pages" in cache:
            L.copy_page_cow(cache, src, dst, valid)
    return state


def decode_step(params, token, state, cfg: ModelConfig, policy: Policy, *,
                moe_impl: str = "replicated", impl: Optional[str] = None):
    """One decode step for every slot.  token: (B, 1).  Each slot writes at
    and advances from its own ``state["pos"]``, where learned positions
    embed it too.  An encoder-decoder's cross sublayers read the state's
    cross caches.  Returns (logits (B, V), state) with the state updated
    in place."""
    pos = state["pos"]
    x = L.embed_tokens(params["embed"], token, cfg, policy, pos_offset=pos)
    for p, st, (mixer, mlp) in zip(params["blocks"], state["blocks"],
                                   cfg.layer_kinds()):
        x, _ = _apply_layer(p, x, cfg, policy, mixer, mlp, state=st,
                            decode_pos=pos, moe_impl=moe_impl, impl=impl)
    x = L.apply_norm(params["final_norm"], x, cfg, policy, impl=impl)
    logits = _lm_logits(params, x, cfg, policy)[:, 0]
    state["pos"] += 1
    return logits, state
