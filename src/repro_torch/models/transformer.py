"""Decoder-only LM (port of ``repro/models/transformer.py`` for dense
attention layers and RWKV-6 layers).

The reference stacks the blocks' weights on a leading axis and runs them
with ``lax.scan``; here each layer is its own dict of tensors in a list and
a Python loop runs them in the same order (block-major, then position in
``block_pattern``), which is the order ``bridge.params_from_jax`` unstacks.

Parameters are a plain dict::

    {"embed": {"tok": (V, d)}, "blocks": [layer, ...],
     "final_norm": {"scale"[, "bias"]}, "lm_head": (d, V)}
    attention layer = {"norm1", "mixer": {"wq" (d,H,Dh), "wk", "wv",
                       "wo" (H,Dh,d)}, "norm2", "mlp": {"wi", "wg", "wo"}}
    rwkv layer = {"norm1", "mixer": time mix, "norm2", "mlp": channel mix}
                 (``models/rwkv.py``; norms are LayerNorms with a bias)

The decode state is ``{"pos": (B,) int32, "blocks": [layer state, ...]}``
with ``{"cache": ...}`` for an attention layer and ``{"tm_shift", "wkv",
"cm_shift"}`` (fp32) for an rwkv layer.  ``prefill`` and ``decode_step``
update it in place and return the same dict.  In a paged state every
layer's cache holds the same ``block_table`` tensor: one logical
allocation per slot serves all layers (the reference keeps one stacked
copy per block).

MoE, mamba, cross-attention, sliding-window and M-RoPE layers belong to
later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.models import layers as L
from repro_torch.models import rwkv as RW

LAYER_KINDS = (("attn", "dense"), ("rwkv", "rwkv_cm"))


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
                f"{kind} layers: the port runs {LAYER_KINDS}; MoE, mamba "
                "and the local/global attention mixers come with later "
                "architecture-family slices")
    if cfg.is_encoder_decoder or cfg.is_encoder_only:
        raise NotImplementedError("encoder-decoder and encoder-only models "
                                  "port with the family and BERT slices")
    if cfg.n_vision_tokens or cfg.post_block_norm or cfg.tie_embeddings:
        raise NotImplementedError("vision stubs, post-block norms and tied "
                                  "embeddings port with the family slice")


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
    for mixer, _ in cfg.layer_kinds():
        if mixer == "rwkv":
            mix, mlp = (RW.init_time_mix(cfg, gen, **kw),
                        RW.init_channel_mix(cfg, gen, **kw))
        else:
            mix, mlp = (L.init_attention(cfg, gen, **kw),
                        L.init_mlp(cfg, gen, **kw))
        params["blocks"].append({"norm1": L.init_norm(cfg, **kw),
                                 "mixer": mix,
                                 "norm2": L.init_norm(cfg, **kw),
                                 "mlp": mlp})
    params["final_norm"] = L.init_norm(cfg, **kw)
    params["lm_head"] = L.trunc_normal((cfg.d_model, cfg.vocab_size), gen,
                                       **kw)
    return params


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16,
                      paged: Optional[PagedCacheConfig] = None,
                      device="cuda") -> dict:
    """Per-layer decode state with per-slot positions ``pos`` (B,).
    ``paged`` replaces each slot's contiguous (max_len, KV, Dh) stripe with
    the global page pool and one block table shared by all layers.  An
    rwkv layer holds its fp32 recurrent rows and no cache (``max_len`` and
    ``cache_dtype`` do not apply to it)."""
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
        if paged is not None:
            cache = L.init_paged_attention_cache(
                cfg, batch, paged.num_pages, paged.page_size,
                table.shape[1], dtype=cache_dtype, quantized=paged.quantized,
                device=device, block_table=table)
        else:
            cache = L.init_attention_cache(cfg, batch, max_len, cache_dtype,
                                           device=device)
        blocks.append({"cache": cache})
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

def _decode_positions(decode_pos: torch.Tensor, s: int = 1) -> torch.Tensor:
    p = decode_pos.long()[:, None]
    return p + torch.arange(s, device=p.device)[None]


def _fit_cache(new_cache: dict, state: dict, valid_len=None) -> None:
    """Write a prefill's contiguous K/V (B, S, KV, Dh) into the layer's
    allocated cache, in place: through the block table for a paged cache,
    else into the first S rows of each stripe (rows past S are zeroed, as
    the reference pads)."""
    cache = state["cache"]
    if "k_pages" in cache:
        L.paged_prefill_write(cache, new_cache["k"], new_cache["v"],
                              valid_len=valid_len)
        return
    s = new_cache["k"].shape[1]
    if s > cache["k"].shape[1]:
        raise NotImplementedError("a prefill wider than the cache wraps a "
                                  "sliding-window ring: family slice")
    for key in ("k", "v"):
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


def _apply_layer(p, x, cfg: ModelConfig, policy: Policy, mixer: str, *,
                 state=None, decode_pos=None, valid_len=None,
                 impl: Optional[str] = None):
    if mixer == "rwkv":
        return _apply_rwkv_layer(p, x, cfg, policy, state=state,
                                 valid_len=valid_len, impl=impl)
    h = L.apply_norm(p["norm1"], x, cfg, policy)
    cache = state.get("cache") if state is not None else None
    if cache is not None and decode_pos is not None:
        if "k_pages" in cache:
            # no ring wrap: a paged write past capacity is routed to the
            # trash page inside apply_attention
            cache_len = cache["block_table"].shape[-1] * cache["k_pages"].shape[1]
            write_pos = decode_pos
        else:
            cache_len = cache["k"].shape[1]
            write_pos = torch.remainder(decode_pos, cache_len)
        kv_len = torch.clamp(decode_pos + h.shape[1], max=cache_len)
        y, _ = L.apply_attention(
            p["mixer"], h, cfg, policy,
            positions=_decode_positions(decode_pos, h.shape[1]), cache=cache,
            cache_pos=write_pos, kv_len=kv_len, impl=impl)
    else:
        y, nc = L.apply_attention(p["mixer"], h, cfg, policy,
                                  return_cache=state is not None, impl=impl)
        if state is not None:
            _fit_cache(nc, state, valid_len)
    x = x + y.to(x.dtype)
    h = L.apply_norm(p["norm2"], x, cfg, policy)
    return x + L.apply_mlp(p["mlp"], h, cfg, policy).to(x.dtype)


def _lm_logits(params, x, cfg: ModelConfig, policy: Policy):
    cdt = policy.compute_dtype
    logits = x.to(cdt) @ params["lm_head"].to(cdt)
    if cfg.final_logit_softcap:
        logits = L._soft_cap(logits.to(policy.reduce_dtype),
                             cfg.final_logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def apply_lm(params, tokens, cfg: ModelConfig, policy: Policy, *,
             impl: Optional[str] = None):
    """Full forward of (B, S) tokens -> logits (B, S, V).  (The reference
    also returns the MoE aux loss, which a dense model does not have.)"""
    x = L.embed_tokens(params["embed"], tokens, cfg, policy)
    for p, (mixer, _) in zip(params["blocks"], cfg.layer_kinds()):
        x = _apply_layer(p, x, cfg, policy, mixer, impl=impl)
    x = L.apply_norm(params["final_norm"], x, cfg, policy, impl=impl)
    return _lm_logits(params, x, cfg, policy)


def prefill(params, tokens, cfg: ModelConfig, policy: Policy, *, state,
            lengths=None, impl: Optional[str] = None):
    """Run the prompt (B, S) through the model, filling ``state`` in place.
    Returns (last-token logits (B, V), state).  ``lengths`` (B,) are the
    true lengths of right-padded prompts: logits are taken at
    ``lengths - 1`` and decode resumes at ``lengths``; rwkv layers then
    run the masked sequential scan, without ``lengths`` the chunked one
    (``kops.wkv6``)."""
    x = L.embed_tokens(params["embed"], tokens, cfg, policy)
    for p, st, (mixer, _) in zip(params["blocks"], state["blocks"],
                                 cfg.layer_kinds()):
        x = _apply_layer(p, x, cfg, policy, mixer, state=st,
                         valid_len=lengths, impl=impl)
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


def decode_step(params, token, state, cfg: ModelConfig, policy: Policy, *,
                impl: Optional[str] = None):
    """One decode step for every slot.  token: (B, 1).  Each slot writes at
    and advances from its own ``state["pos"]``.  Returns (logits (B, V),
    state) with the state updated in place."""
    pos = state["pos"]
    x = L.embed_tokens(params["embed"], token, cfg, policy)
    for p, st, (mixer, _) in zip(params["blocks"], state["blocks"],
                                 cfg.layer_kinds()):
        x = _apply_layer(p, x, cfg, policy, mixer, state=st, decode_pos=pos,
                         impl=impl)
    x = L.apply_norm(params["final_norm"], x, cfg, policy, impl=impl)
    logits = _lm_logits(params, x, cfg, policy)[:, 0]
    state["pos"] += 1
    return logits, state
