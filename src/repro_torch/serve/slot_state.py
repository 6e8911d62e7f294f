"""Per-slot decode-state contract (port of ``repro/serve/slot_state.py``
for attention, RWKV-6 and hybrid attention + mamba architectures).

``SlotStateAdapter`` owns everything architecture-specific about a batch
slot, so ``ContinuousScheduler`` stays pure policy over abstract slots:

* ``init_state()``                    -- allocate the batch's decode state;
* ``prefill(state, tokens, length, slot[, start=, enc_frames=])`` -- one
  request into one slot (``start``: the suffix after a cached prefix,
  paged states; ``enc_frames``: an encoder-decoder's request frames,
  required there, which fill the slot's cross caches at admission);
* ``reset_slot(state, slot)``         -- zero a released slot's position,
  recurrent rows and cross caches;
* ``write_table_row(state, slot, pages)`` -- mirror a slot's page list into
  the block table (unallocated entries point at the trash page);
* ``copy_page(state, src, dst, valid)`` -- copy-on-write of a shared page;
* ``cache_bytes()`` / ``state_bytes()`` -- self-attention KV footprint vs
  the per-slot state (recurrent rows, cross caches), from the sizes of
  the tensors ``init_state`` makes; a hybrid (jamba: paged attention
  layers beside mamba layers) and an encoder-decoder (whisper: its cross
  caches, ``enc_len`` = ``enc_seq`` rows a slot and layer, beside the
  self-attention KV) have both.
* ``has_slot_state`` -- whether any layer keeps per-slot rows outside the
  KV cache (rwkv's and mamba's recurrent rows, whisper's cross caches),
  which ``reset_slot`` zeroes.

Exactness rule (``needs_exact_prefill``): a recurrent scan must not be
advanced by the pad tokens of the prefill bucket.  The slot prefill passes
``lengths``, so rwkv and mamba layers step pad positions with the exact
identity and run their sequential scans, and a padded slot prefill leaves
the same state, bit for bit, as an unpadded prefill of the true prompt.

An MoE model's slot prefills run ``moe_impl`` (default ``"dense"``, as
the reference's adapter).
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
    """The per-slot tensors outside the KV caches: recurrent rows and cross
    caches' K and V, (B, ...) each."""
    return [x for blk in state["blocks"] for k, t in blk.items()
            if k != "cache"
            for x in (t.values() if isinstance(t, dict) else (t,))]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kv_state_bytes(state: dict) -> int:
    return _nbytes(_cache_tensors(state))


class SlotStateAdapter:
    def __init__(self, params, cfg: ModelConfig, policy: Policy, *,
                 batch: int, max_len: int, cache_dtype=torch.bfloat16,
                 paged_cfg: Optional[T.PagedCacheConfig] = None,
                 moe_impl: str = "dense", device="cuda"):
        T.check_supported(cfg)
        self.params, self.cfg, self.policy = params, cfg, policy
        self.moe_impl = moe_impl
        self.batch, self.max_len = batch, max_len
        self.cache_dtype = cache_dtype
        self.paged_cfg = paged_cfg
        self.device = device
        self.enc_len = cfg.enc_seq if cfg.is_encoder_decoder else 0
        self.max_pages = (-(-max_len // paged_cfg.page_size)
                          if paged_cfg is not None else 0)
        shapes = T.init_decode_state(cfg, batch, max_len, cache_dtype,
                                     paged=paged_cfg, device="meta",
                                     enc_len=self.enc_len)
        self._cache_bytes = kv_state_bytes(shapes)
        self.has_slot_state = bool(_slot_tensors(shapes))
        self._state_bytes = _nbytes(_slot_tensors(shapes))

    def init_state(self) -> dict:
        return T.init_decode_state(self.cfg, self.batch, self.max_len,
                                   self.cache_dtype, paged=self.paged_cfg,
                                   device=self.device, enc_len=self.enc_len)

    def prefill(self, state, tokens, length: int, slot: int, *,
                start: Optional[int] = None, enc_frames=None):
        """Prefill one request into ``slot``; ``start`` resumes after a
        cached page-aligned prefix; ``enc_frames`` (1, enc_seq, d_model)
        are an encoder-decoder's request frames, required there, where
        ``start`` is refused (``prefill_into_slot`` raises
        ``ValueError``).  Returns (logits (V,), state)."""
        return prefill_into_slot(self.params, tokens, length, state, slot,
                                 self.cfg, self.policy, start=start,
                                 moe_impl=self.moe_impl,
                                 enc_frames=enc_frames)

    def reset_slot(self, state, slot: int):
        """Zero the slot's position, recurrent rows and cross caches, in
        place.  Hygiene, not correctness: decode steps run over the whole
        batch and advance an empty slot's recurrent rows again, so the next
        prefill zeroes them itself (``prefill_into_slot``), and it
        overwrites a slot's cross caches whole.  KV pages and stripes are
        reclaimed through the tables."""
        state["pos"][slot] = 0
        for t in _slot_tensors(state):
            t[slot].zero_()
        return state

    def write_table_row(self, state, slot: int, pages: List[int]):
        row = np.zeros((self.max_pages,), np.int32)
        row[: len(pages)] = pages
        return T.set_block_tables(state, row, slot=slot)

    def copy_page(self, state, src: int, dst: int, valid: int):
        return T.copy_page(state, src, dst, valid)

    def state_bytes(self) -> int:
        """Bytes of non-KV state over the batch: rwkv's token shifts and
        WKV states (24 x (2 x 2048 x 4 + 32 x 64 x 64 x 4) B, ~12.8 MB, per
        slot of full-width rwkv6-1.6b), mamba's conv and ssm rows ((3 x
        16384 + 16384 x 16) x 4 B, ~1.25 MB, per mamba layer and slot of
        jamba), whisper's cross caches (12 x 2 x 1500 x 768 x 2 B in bf16,
        ~55 MB a slot), whatever ``max_len``; 0 for decoder-only attention
        architectures."""
        return self._state_bytes

    def cache_bytes(self) -> int:
        """Bytes of self-attention KV cache: pages, scales and the block
        table, or the contiguous stripes."""
        return self._cache_bytes
