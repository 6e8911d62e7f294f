"""Per-slot decode-state contract (port of ``repro/serve/slot_state.py``
for dense attention and RWKV-6 architectures).

``SlotStateAdapter`` owns everything architecture-specific about a batch
slot, so ``ContinuousScheduler`` stays pure policy over abstract slots:

* ``init_state()``                    -- allocate the batch's decode state;
* ``prefill(state, tokens, length, slot)`` -- one request into one slot;
* ``reset_slot(state, slot)``         -- zero a released slot's position
  and recurrent rows;
* ``write_table_row(state, slot, pages)`` -- mirror a slot's page list into
  the block table (unallocated entries point at the trash page);
* ``cache_bytes()`` / ``state_bytes()`` -- KV footprint vs recurrent
  state, from the sizes of the tensors ``init_state`` makes.

Exactness rule (``needs_exact_prefill``): a recurrent scan must not be
advanced by the pad tokens of the prefill bucket.  The slot prefill passes
``lengths``, so rwkv layers step pad positions with the exact identity and
run the sequential scan, and a padded slot prefill leaves the same state,
bit for bit, as an unpadded prefill of the true prompt.

Cross-attention state, suffix prefill and copy-on-write come with the
architecture-family and prefix-cache slices.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.models import transformer as T
from repro_torch.serve.serve_step import prefill_into_slot


def _cache_tensors(state: dict):
    """Distinct tensors of the KV caches (the shared block table once)."""
    seen = {}
    for blk in state["blocks"]:
        for t in blk.get("cache", {}).values():
            seen[id(t)] = t
    return list(seen.values())


def _slot_tensors(state: dict):
    """The per-slot tensors outside the KV caches: recurrent rows, (B, ...)
    each."""
    return [t for blk in state["blocks"] for k, t in blk.items()
            if k != "cache"]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kv_state_bytes(state: dict) -> int:
    return _nbytes(_cache_tensors(state))


class SlotStateAdapter:
    def __init__(self, params, cfg: ModelConfig, policy: Policy, *,
                 batch: int, max_len: int, cache_dtype=torch.bfloat16,
                 paged_cfg: Optional[T.PagedCacheConfig] = None,
                 device="cuda"):
        T.check_supported(cfg)
        self.params, self.cfg, self.policy = params, cfg, policy
        self.batch, self.max_len = batch, max_len
        self.cache_dtype = cache_dtype
        self.paged_cfg = paged_cfg
        self.device = device
        self.max_pages = (-(-max_len // paged_cfg.page_size)
                          if paged_cfg is not None else 0)
        shapes = T.init_decode_state(cfg, batch, max_len, cache_dtype,
                                     paged=paged_cfg, device="meta")
        self._cache_bytes = kv_state_bytes(shapes)
        self._state_bytes = _nbytes(_slot_tensors(shapes))

    def init_state(self) -> dict:
        return T.init_decode_state(self.cfg, self.batch, self.max_len,
                                   self.cache_dtype, paged=self.paged_cfg,
                                   device=self.device)

    def prefill(self, state, tokens, length: int, slot: int):
        """Prefill one request into ``slot``.  Returns (logits (V,), state)."""
        return prefill_into_slot(self.params, tokens, length, state, slot,
                                 self.cfg, self.policy)

    def reset_slot(self, state, slot: int):
        """Zero the slot's position and recurrent rows, in place.  Hygiene,
        not correctness: the next prefill overwrites every row it reads, but
        a zeroed slot decodes from the zero state, never from the previous
        tenant's.  KV pages and stripes are reclaimed through the tables."""
        state["pos"][slot] = 0
        for t in _slot_tensors(state):
            t[slot].zero_()
        return state

    def write_table_row(self, state, slot: int, pages: List[int]):
        row = np.zeros((self.max_pages,), np.int32)
        row[: len(pages)] = pages
        return T.set_block_tables(state, row, slot=slot)

    def state_bytes(self) -> int:
        """Bytes of non-KV state over the batch: rwkv's token shifts and
        WKV states (24 x (2 x 2048 x 4 + 32 x 64 x 64 x 4) B, ~12.8 MB, per
        slot of full-width rwkv6-1.6b, whatever ``max_len``); 0 for
        attention-only architectures."""
        return self._state_bytes

    def cache_bytes(self) -> int:
        """Bytes of self-attention KV cache: pages, scales and the block
        table, or the contiguous stripes."""
        return self._cache_bytes
