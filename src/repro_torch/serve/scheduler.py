"""Continuous-batching request scheduler (port of
``repro/serve/scheduler.py``: ``Request``, ``ServeStats``,
``kv_cache_bytes``, ``PageAllocator`` and ``ContinuousScheduler``).

Every batch slot decodes at its own position; the moment a slot's request
hits EOS or its token budget it is evicted and refilled with a
single-request prefill into that slot.  ``cache_mode`` picks the KV layout:
``"contiguous"`` (a (max_len, KV, Dh) stripe per slot) or ``"paged"`` /
``"paged_int8"`` (a global page pool with per-slot block tables, pages
granted at admission, grown one at a time during decode and returned at
eviction; the youngest slot is preempted when the pool runs dry).
``Request.deadline_s`` evicts a request past its wall-clock budget.

The scheduler sees slots only through ``SlotStateAdapter``, so a recurrent
architecture (rwkv6-1.6b) serves through the same loop: it is not
pageable, so it takes ``cache_mode="contiguous"`` and holds no KV at all
(``cache_bytes`` 0); its per-slot state is the fixed-size recurrent rows
(``state_bytes``), and every admission runs the masked sequential scan.

The host policy is numpy and Python, as in the reference.  The prefix trie
and copy-on-write (ROADMAP Queue 1 item 2) and ``CohortScheduler`` (item
3) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.amp import Policy
from repro_torch.models import transformer as T
from repro_torch.serve.slot_state import SlotStateAdapter, kv_state_bytes


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (len,) int32
    max_new_tokens: int = 32
    arrival_s: float = 0.0       # offset from run start (trace replay)
    deadline_s: Optional[float] = None  # wall-clock budget from arrival
    output: Optional[np.ndarray] = None
    first_token_s: float = 0.0   # arrival -> first generated token
    latency_s: float = 0.0       # arrival -> completion
    timed_out: bool = False


@dataclasses.dataclass
class ServeStats:
    prefills: int = 0
    decode_steps: int = 0
    useful_tokens: int = 0
    wasted_slots: int = 0        # decode slots spent on empty slots
    preemptions: int = 0         # paged: slots evicted to reclaim pages
    timeouts: int = 0            # requests evicted past their deadline_s
    wall_s: float = 0.0
    decode_s: float = 0.0        # time inside decode steps (after the first)
    decode_tokens: int = 0       # useful tokens those steps produced
    prefill_tokens: int = 0      # prompt tokens run through prefill
    nonfinite_logits: int = 0    # prefills / live decode rows whose logits
    #                              held a NaN or inf (the chip smoke wants 0)
    cache_bytes: int = 0         # self-attention KV: pages/tables or stripes
    state_bytes: int = 0         # recurrent rows over the batch

    @property
    def slot_utilisation(self) -> float:
        total = self.useful_tokens + self.wasted_slots
        return self.useful_tokens / total if total else 1.0

    @property
    def tokens_per_s(self) -> float:
        return self.useful_tokens / self.wall_s if self.wall_s else 0.0

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


class PageAllocator:
    """Free-list allocator over a global KV page pool.  Page 0 is the trash
    page and never handed out.  ``alloc`` is all-or-nothing; freeing a page
    that is not allocated raises."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("pool needs the trash page plus one real page")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))
        self._used: set = set()

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._used)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._used.update(pages)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._used:
                raise ValueError(f"double free or foreign page id {p}")
            self._used.remove(p)
            self._free.append(p)


def kv_cache_bytes(cfg: ModelConfig, batch: int, max_len: int, *,
                   paged: Optional[T.PagedCacheConfig] = None,
                   cache_dtype=torch.bfloat16) -> int:
    """Bytes of self-attention KV cache state for this geometry (counted on
    the meta device: nothing is allocated)."""
    return kv_state_bytes(T.init_decode_state(
        cfg, batch, max_len, cache_dtype, paged=paged, device="meta"))


class ContinuousScheduler:
    """Slot-refilling scheduler: evict on EOS/budget, refill immediately.

    ``prefill_len`` is the right-padded prompt bucket; longer prompts keep
    their last ``prefill_len`` tokens.  See the module docstring for the
    cache modes, preemption and deadlines.
    """

    def __init__(self, params, cfg: ModelConfig, policy: Policy, *,
                 batch: int, max_len: int, prefill_len: int = 32,
                 eos_id: int = -1, pad_id: int = 0,
                 cache_mode: str = "contiguous", page_size: int = 16,
                 num_pages: Optional[int] = None,
                 cache_dtype=torch.bfloat16, device="cuda"):
        if prefill_len > max_len:
            raise ValueError(f"prefill_len {prefill_len} > max_len {max_len}")
        if cache_mode not in ("contiguous", "paged", "paged_int8"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if cache_mode != "contiguous" and not cfg.decode_caps.pageable:
            raise ValueError(f"{cfg.arch_id} is not pageable: serve it with "
                             "cache_mode='contiguous'")
        self.params, self.cfg, self.policy = params, cfg, policy
        self.batch, self.max_len = batch, max_len
        self.eos_id, self.pad_id = eos_id, pad_id
        self.queue: List[Request] = []
        self.stats = ServeStats()
        self.prefill_len = prefill_len
        self.cache_mode = cache_mode
        self.cache_dtype = cache_dtype
        self.page_size = page_size
        self.device = device
        self.max_pages = -(-max_len // page_size)
        if cache_mode == "contiguous":
            self.num_pages = 0
            self.paged_cfg = None
            self.allocator = None
        else:
            self.num_pages = (num_pages if num_pages is not None
                              else 1 + batch * self.max_pages)
            self.paged_cfg = T.PagedCacheConfig(
                page_size=page_size, num_pages=self.num_pages,
                quantized=(cache_mode == "paged_int8"))
            self.allocator = PageAllocator(self.num_pages)
        self.adapter = SlotStateAdapter(
            params, cfg, policy, batch=batch, max_len=max_len,
            cache_dtype=cache_dtype, paged_cfg=self.paged_cfg,
            device=device)
        self.stats.cache_bytes = self.adapter.cache_bytes()
        self.stats.state_bytes = self.adapter.state_bytes()

    def submit(self, req: Request):
        need = min(len(req.prompt), self.prefill_len) + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new_tokens needs {need} "
                f"cache slots > max_len {self.max_len}")
        if self.allocator is not None:
            worst = -(-need // self.page_size)
            if worst > self.num_pages - 1:
                raise ValueError(
                    f"request {req.rid}: needs {worst} pages > pool "
                    f"{self.num_pages - 1} (can never be scheduled)")
        self.queue.append(req)

    def _bucket(self, prompt: np.ndarray):
        """Right-pad (or left-truncate) a prompt to the prefill bucket."""
        p = self.prefill_len
        prompt = np.asarray(prompt, np.int32)[-p:]
        toks = np.full((1, p), self.pad_id, np.int32)
        toks[0, : len(prompt)] = prompt
        return torch.from_numpy(toks).to(self.device), len(prompt)

    def run(self) -> List[Request]:
        done: List[Request] = []
        t0 = time.perf_counter()
        pending = sorted(self.queue, key=lambda r: r.arrival_s)
        self.queue = []
        state = self.adapter.init_state()
        slots: List[Optional[Request]] = [None] * self.batch
        gens: List[List[int]] = [[] for _ in range(self.batch)]
        prefix: List[List[int]] = [[] for _ in range(self.batch)]
        # rid -> (prompt incl. generated tokens, remaining budget, output
        # prefix) of a preempted request; never written into the Request
        resume: dict = {}
        cur = np.zeros((self.batch, 1), np.int64)
        slot_pages: List[List[int]] = [[] for _ in range(self.batch)]
        slot_prompt: List[Optional[np.ndarray]] = [None] * self.batch
        slot_budget: List[int] = [0] * self.batch
        kv_next: List[int] = [0] * self.batch   # next cache write index
        admit_seq: List[int] = [0] * self.batch
        seq = 0

        def release(i: int):
            nonlocal state
            slots[i] = None
            prefix[i] = []
            if self.allocator is not None:
                if slot_pages[i]:
                    self.allocator.free(slot_pages[i])
                    slot_pages[i] = []
                # the empty slot's dead decode writes go to the trash page
                state = self.adapter.write_table_row(state, i, [])
            state = self.adapter.reset_slot(state, i)

        def finish(i: int, now: float, timed_out: bool = False):
            req = slots[i]
            req.output = np.asarray(prefix[i] + gens[i], np.int32)
            req.latency_s = now - req.arrival_s
            if timed_out:
                req.timed_out = True
                self.stats.timeouts += 1
            done.append(req)
            release(i)

        def preempt(i: int):
            req = slots[i]
            resume[req.rid] = (
                np.concatenate([np.asarray(slot_prompt[i], np.int32),
                                np.asarray(gens[i], np.int32)]),
                slot_budget[i] - len(gens[i]),
                prefix[i] + gens[i])
            pending.insert(0, req)
            self.stats.preemptions += 1
            release(i)

        while pending or any(s is not None for s in slots):
            now = time.perf_counter() - t0
            for i in range(self.batch):
                req = slots[i]
                if req is not None and req.deadline_s is not None and \
                        now - req.arrival_s > req.deadline_s:
                    finish(i, now, timed_out=True)
            # --- admission: refill every empty slot that has an arrival ---
            for i in range(self.batch):
                while slots[i] is None and pending and \
                        pending[0].arrival_s <= now:
                    req = pending[0]
                    if req.deadline_s is not None and \
                            now - req.arrival_s > req.deadline_s:
                        pending.pop(0)
                        _, _, out_prefix = resume.pop(req.rid, (None, 0, []))
                        req.output = np.asarray(out_prefix, np.int32)
                        req.latency_s = max(now - req.arrival_s, 0.0)
                        req.timed_out = True
                        self.stats.timeouts += 1
                        done.append(req)
                        continue
                    if req.max_new_tokens <= 0:
                        pending.pop(0)
                        req.output = np.zeros((0,), np.int32)
                        req.latency_s = max(now - req.arrival_s, 0.0)
                        done.append(req)
                        continue
                    prompt, budget, out_prefix = resume.pop(
                        req.rid, (req.prompt, req.max_new_tokens, []))
                    toks, length = self._bucket(prompt)
                    if self.allocator is not None:
                        # pages for the prompt + the first decode write
                        need = -(-(length + 1) // self.page_size)
                        pages = self.allocator.alloc(need)
                        if pages is None:
                            resume.setdefault(req.rid,
                                              (prompt, budget, out_prefix))
                            break  # pool dry: wait for an eviction
                        slot_pages[i] = pages
                        state = self.adapter.write_table_row(state, i, pages)
                    pending.pop(0)
                    logits, state = self.adapter.prefill(state, toks, length,
                                                         i)
                    self.stats.prefill_tokens += length
                    self.stats.prefills += 1
                    if not bool(torch.isfinite(logits).all()):
                        self.stats.nonfinite_logits += 1
                    tok0 = int(logits.argmax())
                    self.stats.useful_tokens += 1
                    now = time.perf_counter() - t0
                    if not req.first_token_s:
                        req.first_token_s = now - req.arrival_s
                    slots[i] = req
                    slot_prompt[i], slot_budget[i] = prompt, budget
                    prefix[i] = list(out_prefix)
                    gens[i] = [tok0]
                    cur[i, 0] = tok0
                    kv_next[i] = length
                    seq += 1
                    admit_seq[i] = seq
                    if (self.eos_id >= 0 and tok0 == self.eos_id) or \
                            budget == 1:
                        finish(i, now)
            if not any(s is not None for s in slots):
                if pending:  # idle until the next arrival
                    time.sleep(max(0.0, pending[0].arrival_s -
                                   (time.perf_counter() - t0)))
                    continue
                break
            # --- paged: grow slots crossing a page boundary this step ---
            if self.allocator is not None:
                for i in range(self.batch):
                    while slots[i] is not None and \
                            kv_next[i] // self.page_size >= len(slot_pages[i]):
                        pg = self.allocator.alloc(1)
                        if pg is not None:
                            slot_pages[i].append(pg[0])
                            state = self.adapter.write_table_row(
                                state, i, slot_pages[i])
                            continue
                        active = [j for j in range(self.batch)
                                  if slots[j] is not None]
                        preempt(max(active, key=lambda j: admit_seq[j]))
                if not any(s is not None for s in slots):
                    continue  # everyone preempted: back to admission
            # --- one decode step for the whole batch, slots independent ---
            n_active = sum(s is not None for s in slots)
            t_step = time.perf_counter()
            logits, state = T.decode_step(
                self.params, torch.from_numpy(cur).to(self.device), state,
                self.cfg, self.policy)
            col = logits.argmax(-1).cpu().numpy()
            finite = torch.isfinite(logits).all(-1).cpu().numpy()
            self.stats.decode_steps += 1
            if self.stats.decode_steps > 1:  # the first step bears warm-up
                self.stats.decode_s += time.perf_counter() - t_step
                self.stats.decode_tokens += n_active
            now = time.perf_counter() - t0
            for i in range(self.batch):
                if slots[i] is None:
                    self.stats.wasted_slots += 1
                    continue
                if not finite[i]:
                    self.stats.nonfinite_logits += 1
                self.stats.useful_tokens += 1
                kv_next[i] += 1
                gens[i].append(int(col[i]))
                cur[i, 0] = int(col[i])
                if (self.eos_id >= 0 and col[i] == self.eos_id) or \
                        len(gens[i]) >= slot_budget[i]:
                    finish(i, now)
        self.stats.wall_s += time.perf_counter() - t0
        return done
