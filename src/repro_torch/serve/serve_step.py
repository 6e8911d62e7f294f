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
reference.  An rwkv layer's view is its slot's rows of the recurrent
state, which the masked prefill overwrites in place.  The prefix-cache
``start`` (suffix) mode is a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.models import transformer as T


def cache_extent(state: dict) -> Optional[int]:
    """Per-slot KV capacity of a decode state (max_pages * page_size for a
    paged cache, the stripe length for a contiguous one); None for an
    attention-free state, which has no KV extent."""
    for st in state["blocks"]:
        cache = st.get("cache")
        if cache is None:
            continue
        if "k_pages" in cache:
            return cache["block_table"].shape[1] * cache["k_pages"].shape[1]
        return cache["k"].shape[1]
    return None


def slot_view(state: dict, slot: int) -> dict:
    """A one-row decode state whose tensors are views of ``slot``'s rows of
    the live ``state`` (page pools are shared whole; recurrent rows are
    views too)."""
    rows = slice(slot, slot + 1)
    blocks = []
    for st in state["blocks"]:
        row = {k: t[rows] for k, t in st.items() if k != "cache"}
        c = st.get("cache")
        if c is not None and "k_pages" in c:
            row["cache"] = dict(c, block_table=c["block_table"][rows])
        elif c is not None:
            row["cache"] = {"k": c["k"][rows], "v": c["v"][rows]}
        blocks.append(row)
    return {"pos": state["pos"][rows], "blocks": blocks}


def prefill_into_slot(params, tokens, length: int, state: dict, slot: int,
                      cfg: ModelConfig, policy: Policy, *,
                      impl: Optional[str] = None):
    """Prefill ONE right-padded request (1, P) of true length ``length``
    into live slot ``slot``; neighbouring slots are untouched.  A paged
    state needs the slot's block-table row written first.  Returns
    (next-token logits (V,), state), the state updated in place."""
    b1, p = tokens.shape
    if b1 != 1:
        raise ValueError("prefill_into_slot takes a single request")
    extent = cache_extent(state)
    if extent is not None and p > extent:
        raise ValueError(f"prefill bucket {p} exceeds the cache extent "
                         f"{extent}")
    row = slot_view(state, slot)
    lengths = torch.tensor([length], dtype=torch.int32,
                           device=state["pos"].device)
    logits, _ = T.prefill(params, tokens, cfg, policy, state=row,
                          lengths=lengths, impl=impl)
    return logits[0], state


def greedy_generate(params, prompt, cfg: ModelConfig, policy: Policy, *,
                    max_new: int = 16, max_len: int = 256):
    """Greedy generation of ``max_new`` tokens for a (B, S) prompt with a
    float32 contiguous cache.  Returns (B, max_new) token ids.  A recurrent
    architecture (``needs_exact_prefill``) prefills with full-width
    ``lengths``, so it takes the masked sequential scan that
    ``prefill_into_slot`` takes, as the reference does: the scheduler's
    outputs are comparable with these token for token."""
    b, s = prompt.shape
    state = T.init_decode_state(cfg, b, max_len, torch.float32,
                                device=prompt.device)
    lengths = (torch.full((b,), s, dtype=torch.int32, device=prompt.device)
               if cfg.decode_caps.needs_exact_prefill else None)
    logits, state = T.prefill(params, prompt, cfg, policy, state=state,
                              lengths=lengths)
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    for _ in range(max_new - 1):
        logits, state = T.decode_step(params, tok, state, cfg, policy)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
