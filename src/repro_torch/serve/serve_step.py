"""Serving steps: prefill one request into a live slot, and greedy
generation (port of ``prefill_into_slot`` and ``greedy_generate`` in
``repro/serve/serve_step.py``).

The reference prefills into a fresh one-row state and scatters that row
into the live state (``dynamic_update_slice``, or ``_scatter_row_into_pages``
for a paged cache).  The port prefills straight into the slot: the
one-row state it hands to ``transformer.prefill`` is a set of views of the
live tensors -- the slot's stripe of a contiguous cache, or the shared page
pool with the slot's block-table row -- so the prefill writes the slot's
rows and pages in place and touches nothing of its neighbours.  The pages
written are the ``ceil(P / page_size)`` that the bucket covers, as in the
reference.  A recurrent layer's (rwkv's, mamba's) view is its slot's rows
of the recurrent state, zeroed before the masked prefill overwrites them
in place: the prefill starts from the zero state, as the reference's fresh
row does, whatever decode steps did to an empty slot's rows.

The prefix cache's ``start`` (suffix) mode cannot prefill through views:
the suffix's queries must read the cached prefix.  It gathers the slot's
pages into a one-row contiguous scratch state (int8 pages dequantised into
fp32, as the reference's ``_cache_geometry`` chooses), runs
``transformer.prefill_suffix`` over it and writes back only the pages that
cover [start, start + ceil(P / page_size) * page_size); pages below
``start`` -- shared, possibly read by sibling slots -- are never
rewritten.

An encoder-decoder (whisper) runs its encoder over the request's frames
at admission and writes the encoder's K and V into its slot's rows of
every layer's ``cross`` cache, the slot's view of it, and nothing else;
it has no suffix mode (frames are not in the prefix cache's token hash).

A vision-language model (qwen2-vl) is prefilled into a slot on its tokens
alone: the slot path takes no vision embeddings, as the reference's
scheduler sends none (its ``Request`` has no vision field), and its
M-RoPE positions are ``arange`` on the three axes.  Vision embeddings
reach a raw prefill (``transformer.prefill(vision_embeds=)``) and
``greedy_generate``.  Its caches still depend on them there, so the
prefix cache refuses it (``DecodeCaps.prefix_shareable``).

An MoE model's layers run ``moe_impl``; the serving default is
``"dense"``, as the reference's.  Under the capacity path (``"a2a"``)
the slot prefill routes the bucket's P tokens, pads included, as the
reference's one-row prefill does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def cache_extent(state: dict) -> Optional[int]:
    """Per-slot KV capacity of a decode state (max_pages * page_size for a
    paged cache, the longest stripe for a contiguous one: a sliding-window
    ring may be shorter); None for an attention-free state, which has no
    KV extent."""
    extents = [c["block_table"].shape[1] * c["k_pages"].shape[1]
               if "k_pages" in c else c["k"].shape[1]
               for c in (st.get("cache") for st in state["blocks"]) if c]
    return max(extents, default=None)


def slot_view(state: dict, slot: int) -> dict:
    """A one-row decode state whose tensors are views of ``slot``'s rows of
    the live ``state`` (page pools are shared whole; recurrent rows and
    cross caches are views too)."""
    rows = slice(slot, slot + 1)
    blocks = []
    for st in state["blocks"]:
        row = {k: ({n: x[rows] for n, x in t.items()} if isinstance(t, dict)
                   else t[rows]) for k, t in st.items() if k != "cache"}
        c = st.get("cache")
        if c is not None and "k_pages" in c:
            row["cache"] = dict(c, block_table=c["block_table"][rows])
        elif c is not None:
            row["cache"] = {"k": c["k"][rows], "v": c["v"][rows]}
        blocks.append(row)
    return {"pos": state["pos"][rows], "blocks": blocks}


def _gather_pages_into_row(cache: dict, slot: int):
    """The pages ``block_table[slot]`` names, read back into one contiguous
    row (1, max_pages * page_size, KV, Dh) each of K and V; int8 pages are
    dequantised through their scales into fp32.  Rows past the slot's true
    length are garbage that the suffix prefill masks (``kv_len``) or
    overwrites."""
    bt = cache["block_table"][slot].long()
    out = []
    for pk, sk in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
        pages = cache[pk][bt]                               # (mp, ps, KV, Dh)
        if sk in cache:
            pages = pages.to(torch.float32) * cache[sk][bt][:, None, :, None]
        out.append(pages.reshape(1, -1, *pages.shape[2:]))
    return out


def _scatter_suffix_into_pages(cache: dict, row: dict, slot: int,
                               start: int, length: int, width: int) -> None:
    """Write the scratch row's rows [start, start + n * page_size), n =
    ceil(width / page_size), into the pages ``block_table[slot]`` names at
    those positions, in place (``layers.paged_prefill_write``: rows past the
    suffix's ``length`` zeroed, int8 pages requantised).  A page index past
    the table goes to the trash page 0."""
    ps = cache["k_pages"].shape[1]
    bt = cache["block_table"][slot]
    mp, cap = bt.shape[0], row["k"].shape[1]
    n = min(cap, -(-width // ps) * ps) // ps
    dev = bt.device
    idx = start // ps + torch.arange(n, device=dev)
    pids = torch.where(idx < mp, bt[torch.clamp(idx, max=mp - 1)],
                       torch.zeros_like(idx, dtype=bt.dtype))
    rows = torch.clamp(start + torch.arange(n * ps, device=dev), max=cap - 1)
    view = dict(cache, block_table=pids[None].to(torch.int32))
    L.paged_prefill_write(view, row["k"][:, rows], row["v"][:, rows],
                          valid_len=torch.tensor([length], device=dev))


def _prefill_suffix_into_slot(params, tokens, length: int, state: dict,
                              slot: int, start: int, cfg: ModelConfig,
                              policy: Policy, moe_impl: str,
                              impl: Optional[str]):
    p = tokens.shape[1]
    caches = [st.get("cache") for st in state["blocks"]]
    if any(c is None or "k_pages" not in c for c in caches):
        raise ValueError("suffix prefill requires a paged cache in every "
                         "layer")
    ps = caches[0]["k_pages"].shape[1]
    extent = cache_extent(state)
    if start % ps:
        raise ValueError(f"suffix start {start} is not page-aligned "
                         f"(page_size {ps})")
    if start + p > extent:
        raise ValueError(f"suffix bucket [{start}, {start + p}) exceeds the "
                         f"cache extent {extent}")
    blocks = []
    for c in caches:
        k, v = _gather_pages_into_row(c, slot)
        blocks.append({"cache": {"k": k, "v": v}})
    dev = state["pos"].device
    row = {"pos": torch.zeros((1,), dtype=torch.int32, device=dev),
           "blocks": blocks}
    logits, row = T.prefill_suffix(params, tokens, start, length, cfg, policy,
                                   state=row, moe_impl=moe_impl, impl=impl)
    for c, st in zip(caches, row["blocks"]):
        _scatter_suffix_into_pages(c, st["cache"], slot, start, length, p)
    state["pos"][slot] = row["pos"][0]
    return logits[0], state


def prefill_into_slot(params, tokens, length: int, state: dict, slot: int,
                      cfg: ModelConfig, policy: Policy, *,
                      start: Optional[int] = None, moe_impl: str = "dense",
                      enc_frames=None, impl: Optional[str] = None):
    """Prefill ONE right-padded request (1, P) of true length ``length``
    into live slot ``slot``; neighbouring slots are untouched.  A paged
    state needs the slot's block-table row written first.  P may not exceed
    the cache extent, nor a sliding-window ring's rows (``ValueError``, as
    the reference asserts).  Returns
    (next-token logits (V,), state), the state updated in place.

    ``start`` (paged states only, page-aligned): the slot's table already
    maps ``start`` cached positions; ``tokens`` holds only the uncached
    suffix, of true length ``length``, and ``start + P`` must lie within
    the cache extent.

    ``enc_frames`` (1, enc_seq, d_model): an encoder-decoder's request
    frames, required there (``ValueError`` without them, and with
    ``start``)."""
    b1, p = tokens.shape
    if b1 != 1:
        raise ValueError("prefill_into_slot takes a single request")
    if cfg.is_encoder_decoder and (enc_frames is None or start is not None):
        raise ValueError(f"{cfg.arch_id}: an encoder-decoder slot prefill "
                         "takes the request's enc_frames and no suffix start "
                         "(no prefix resume)")
    extent = cache_extent(state)
    if extent is not None and p > extent:
        raise ValueError(f"prefill bucket {p} exceeds the cache extent "
                         f"{extent}")
    ring = min((st["cache"]["k"].shape[1] for st in state["blocks"]
                if "k" in st.get("cache", {})), default=None)
    if ring is not None and p > ring:
        # a masked slot prefill cannot roll a ring: its pad tokens would
        # push true positions out of the window
        raise ValueError(f"prefill bucket {p} exceeds a sliding-window "
                         f"ring of {ring} rows")
    if start is not None:
        return _prefill_suffix_into_slot(params, tokens, length, state, slot,
                                         start, cfg, policy, moe_impl, impl)
    row = slot_view(state, slot)
    for st in row["blocks"]:
        # a fresh row, as the reference's: decode steps over the whole
        # batch advance an empty slot's recurrent rows too (a cross cache
        # is overwritten whole by the prefill)
        for key, t in st.items():
            if key not in ("cache", "cross"):
                t.zero_()
    lengths = torch.tensor([length], dtype=torch.int32,
                           device=state["pos"].device)
    logits, _ = T.prefill(params, tokens, cfg, policy, state=row,
                          lengths=lengths, enc_frames=enc_frames,
                          moe_impl=moe_impl, impl=impl)
    return logits[0], state


def greedy_generate(params, prompt, cfg: ModelConfig, policy: Policy, *,
                    max_new: int = 16, max_len: int = 256,
                    moe_impl: str = "dense", enc_frames=None,
                    vision_embeds=None):
    """Greedy generation of ``max_new`` tokens for a (B, S) prompt with a
    float32 contiguous cache.  Returns (B, max_new) token ids.  A recurrent
    architecture (``needs_exact_prefill``) prefills with full-width
    ``lengths``, so it takes the masked sequential scan that
    ``prefill_into_slot`` takes, as the reference does: the scheduler's
    outputs are comparable with these token for token.  An encoder-decoder
    takes ``enc_frames`` (B, enc_seq, d_model), a vision model
    ``vision_embeds`` (B, n_vision_tokens, d_model)."""
    b, s = prompt.shape
    enc_len = cfg.enc_seq if cfg.is_encoder_decoder else 0
    state = T.init_decode_state(cfg, b, max_len, torch.float32,
                                device=prompt.device, enc_len=enc_len)
    lengths = (torch.full((b,), s, dtype=torch.int32, device=prompt.device)
               if cfg.decode_caps.needs_exact_prefill else None)
    logits, state = T.prefill(params, prompt, cfg, policy, state=state,
                              lengths=lengths, enc_frames=enc_frames,
                              vision_embeds=vision_embeds,
                              moe_impl=moe_impl)
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    for _ in range(max_new - 1):
        logits, state = T.decode_step(params, tok, state, cfg, policy,
                                      moe_impl=moe_impl)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
