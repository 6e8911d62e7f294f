"""Per-slot decode-state contract (port of ``repro/serve/slot_state.py``
for attention-only architectures).

``SlotStateAdapter`` owns everything architecture-specific about a batch
slot, so ``ContinuousScheduler`` stays pure policy over abstract slots:

* ``init_state()``                    -- allocate the batch's decode state;
* ``prefill(state, tokens, length, slot)`` -- one request into one slot;
* ``reset_slot(state, slot)``         -- clear a released slot's position;
* ``write_table_row(state, slot, pages)`` -- mirror a slot's page list into
  the block table (unallocated entries point at the trash page);
* ``cache_bytes()`` / ``state_bytes()`` -- KV footprint vs per-slot state,
  from the sizes of the tensors ``init_state`` makes.

Recurrent and cross-attention state, suffix prefill and copy-on-write come
with the architecture-family and prefix-cache slices.
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
        for t in blk["cache"].values():
            seen[id(t)] = t
    return list(seen.values())


def kv_state_bytes(state: dict) -> int:
    return sum(t.numel() * t.element_size() for t in _cache_tensors(state))


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
        # attention-only: every per-slot tensor is KV cache; the positions
        # vector is the only other state
        self._cache_bytes = kv_state_bytes(T.init_decode_state(
            cfg, batch, max_len, cache_dtype, paged=paged_cfg, device="meta"))

    def init_state(self) -> dict:
        return T.init_decode_state(self.cfg, self.batch, self.max_len,
                                   self.cache_dtype, paged=self.paged_cfg,
                                   device=self.device)

    def prefill(self, state, tokens, length: int, slot: int):
        """Prefill one request into ``slot``.  Returns (logits (V,), state)."""
        return prefill_into_slot(self.params, tokens, length, state, slot,
                                 self.cfg, self.policy)

    def reset_slot(self, state, slot: int):
        state["pos"][slot] = 0
        return state

    def write_table_row(self, state, slot: int, pages: List[int]):
        row = np.zeros((self.max_pages,), np.int32)
        row[: len(pages)] = pages
        return T.set_block_tables(state, row, slot=slot)

    def state_bytes(self) -> int:
        """Bytes of per-slot non-KV state (recurrent / cross caches): 0 for
        attention-only architectures."""
        return 0

    def cache_bytes(self) -> int:
        """Bytes of self-attention KV cache: pages, scales and the block
        table, or the contiguous stripes."""
        return self._cache_bytes
