"""Request schedulers for serving (port of ``repro/serve/scheduler.py``:
``Request``, ``ServeStats``, ``PageAllocator``, ``kv_cache_bytes``,
``CohortScheduler`` and ``ContinuousScheduler``).

``CohortScheduler`` takes up to ``batch`` queued prompts, left-pads them to
the longest, prefills them together and decodes the cohort in lockstep
until every request is done; finished slots keep decoding and count as
``wasted_slots``.

``ContinuousScheduler`` lets every batch slot decode at its own position;
the moment a slot's request hits EOS or its token budget it is evicted and
refilled with a single-request prefill into that slot.  ``cache_mode``
picks the KV layout: ``"contiguous"`` (a (max_len, KV, Dh) stripe per
slot) or ``"paged"`` / ``"paged_int8"`` (a global page pool with per-slot
block tables, pages granted at admission, grown one at a time during
decode and returned at eviction; the youngest slot is preempted when the
pool runs dry).  ``Request.deadline_s`` evicts a request past its
wall-clock budget.

``prefix_cache=True`` (paged modes) makes the allocator a refcounted prefix
cache: prompts are chain-hashed in page-size chunks, an admission maps the
longest cached page-aligned prefix into its block table and prefills only
the uncached suffix (a whole-prompt hit skips the prefill), a decode write
into a shared page copies it first (copy-on-write), and zero-ref cached
pages are reclaimed, oldest leaf first, before any slot is preempted.

The continuous scheduler sees slots only through ``SlotStateAdapter``, so
a recurrent architecture (rwkv6-1.6b) serves through the same loop: it is
not pageable, so it takes ``cache_mode="contiguous"`` and holds no KV at
all (``cache_bytes`` 0); its per-slot state is the fixed-size recurrent
rows (``state_bytes``), and every admission runs the masked sequential
scan.  gemma2-27b's local layers keep sliding-window rings, which cannot
be paged either: it serves in ``"contiguous"`` mode with a prefill bucket
no wider than its window.  An encoder-decoder (whisper-small) needs each
request's ``enc_frames``: its admission runs the encoder and fills the
slot's cross caches, beside its self-attention KV in any cache mode; the
prefix cache and the cohort scheduler refuse it.  A vision-language model
(qwen2-vl-7b) serves text-only in both schedulers, as the reference's
``Request`` carries no vision embeddings; the prefix cache refuses it
all the same (``DecodeCaps.prefix_shareable``: its caches depend on
vision embeddings wherever they are given).  An MoE model's layers run ``moe_impl``
(default ``"dense"``, as the reference's schedulers: every expert on every
token, so a token's output does not depend on what shares its batch).

The host policy is numpy and Python, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
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
    enc_frames: Optional[np.ndarray] = None  # (enc_seq, d_model): an
    #                              encoder-decoder's input (whisper),
    #                              required there, encoded at admission
    output: Optional[np.ndarray] = None
    first_token_s: float = 0.0   # arrival -> first generated token
    latency_s: float = 0.0       # arrival -> completion
    timed_out: bool = False


@dataclasses.dataclass
class ServeStats:
    cohorts: int = 0
    prefills: int = 0
    decode_steps: int = 0
    useful_tokens: int = 0
    wasted_slots: int = 0        # decode slots spent on finished/empty slots
    preemptions: int = 0         # paged: slots evicted to reclaim pages
    timeouts: int = 0            # requests evicted past their deadline_s
    wall_s: float = 0.0
    decode_s: float = 0.0        # time inside decode steps (after the first)
    decode_tokens: int = 0       # useful tokens those steps produced
    # prefix caching (paged modes with prefix_cache=True)
    prefix_lookups: int = 0      # admissions that consulted the prefix index
    prefix_hits: int = 0         # admissions that mapped >= 1 cached page
    prefix_full_hits: int = 0    # whole prompt cached: prefill skipped
    prefill_tokens: int = 0      # prompt tokens run through prefill
    prefill_tokens_saved: int = 0  # prompt tokens served from cached pages
    pages_shared: int = 0        # cached pages mapped into admitted slots
    cow_copies: int = 0          # copy-on-write page duplications
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
    def prefix_hit_rate(self) -> float:
        return (self.prefix_hits / self.prefix_lookups
                if self.prefix_lookups else 0.0)

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


class PageAllocator:
    """Refcounting allocator over a global KV page pool, with an optional
    prefix index for sharing pages across slots.

    Page 0 is the trash page and never handed out.  ``alloc`` is
    all-or-nothing and starts each page at refcount 1; ``ref`` maps pages
    into one more slot; ``free`` drops one reference, and a page leaves
    circulation only at zero.  Freeing a page that holds no reference
    raises.

    ``prefix_cache=True`` adds a page-granular trie: prompts are
    chain-hashed in ``page_size``-token chunks, keyed ``(parent_page,
    chunk_bytes) -> page``, so two prompts share exactly the pages of their
    longest common page-aligned prefix.  A registered page whose refcount
    reaches zero parks in an LRU of reclaimable cached pages instead of the
    free list (the next admission with that prefix revives it), and
    ``alloc`` reclaims the LRU-oldest leaf only when the free list is dry,
    so cached pages always go before a live slot is preempted.  A slot maps
    a node's whole ancestor chain, so a zero-ref node's children are zero-ref
    too and the LRU always holds a leaf.
    """

    def __init__(self, num_pages: int, page_size: int = 16,
                 prefix_cache: bool = False):
        if num_pages < 2:
            raise ValueError("pool needs the trash page plus one real page")
        self.num_pages = num_pages
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        self.reclaimed = 0           # cached pages sacrificed to allocation
        self._free = list(range(num_pages - 1, 0, -1))
        self._ref: dict = {}         # page -> refcount (> 0)
        self._node: dict = {}        # (parent_page, chunk_bytes) -> page
        self._key: dict = {}         # registered page -> its _node key
        self._nchild: dict = {}      # registered page -> child node count
        self._first_tok: dict = {}   # page -> first greedy token of the
        #                              prompt that ends exactly at this node
        self._lru: OrderedDict = OrderedDict()  # zero-ref cached pages

    @property
    def available(self) -> int:
        """Pages an ``alloc`` can hand out (free + reclaimable cached)."""
        return len(self._free) + len(self._lru)

    @property
    def cached(self) -> int:
        """Zero-ref pages parked in the prefix cache (reclaimable)."""
        return len(self._lru)

    @property
    def in_use(self) -> int:
        return len(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free) + len(self._lru):
            return None
        pages = [self._free.pop() if self._free else self._reclaim_one()
                 for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def ref(self, pages: List[int]) -> None:
        """Map live or cached pages into one more slot (+1 each); a zero-ref
        cached page is revived out of the LRU (a foreign page raises
        ``KeyError``)."""
        for p in pages:
            if p in self._ref:
                self._ref[p] += 1
            else:
                del self._lru[p]
                self._ref[p] = 1

    def free(self, pages: List[int]) -> None:
        for p in pages:
            n = self._ref.get(p, 0)
            if n <= 0:
                raise ValueError(f"double free or foreign page id {p}")
            if n > 1:
                self._ref[p] = n - 1
                continue
            del self._ref[p]
            if p in self._key:       # registered: park as reclaimable cache
                self._lru[p] = None
                self._lru.move_to_end(p)
            else:
                self._free.append(p)

    def _chunks(self, tokens) -> List[bytes]:
        toks = np.asarray(tokens, np.int32)
        ps = self.page_size
        return [toks[o: o + ps].tobytes() for o in range(0, len(toks), ps)]

    def match_prefix(self, tokens):
        """Longest cached prefix of ``tokens`` -> (pages, covered,
        first_tok).  ``pages`` is the trie chain, not yet ref'd: callers
        ``ref`` it before any ``alloc`` could reclaim it.  ``covered``
        counts the prompt tokens those pages hold; a partial last chunk
        matches only exactly.  ``first_tok`` is the cached first greedy
        token when the whole prompt ends at a node some registration ended
        at (a full hit), else None."""
        if not self.prefix_cache:
            return [], 0, None
        pages: List[int] = []
        covered, parent = 0, 0
        n = len(tokens)
        for key in self._chunks(tokens):
            page = self._node.get((parent, key))
            if page is None:
                break
            pages.append(page)
            covered += min(self.page_size, n - covered)
            parent = page
        first_tok = (self._first_tok.get(parent)
                     if pages and covered == n else None)
        return pages, covered, first_tok

    def register_prefix(self, tokens, pages: List[int],
                        first_tok: int) -> None:
        """Record that ``pages`` (the slot's pages covering ``tokens``, each
        ref'd by that slot) hold this prompt's KV.  Chunks already in the
        trie are left alone; new ones are inserted under their parent.  A
        chunk the trie holds on a page this slot does not map stops the
        walk (deeper nodes would hang under a page the slot holds no
        reference on, breaking leaf-only reclaim).  ``first_tok`` is cached
        on the end node, so the next identical prompt is a full hit."""
        if not self.prefix_cache:
            return
        parent = 0
        chunks = self._chunks(tokens)
        for j, (key, page) in enumerate(zip(chunks, pages)):
            existing = self._node.get((parent, key))
            if existing is not None and existing != page:
                if j == len(chunks) - 1:
                    self._first_tok.setdefault(existing, int(first_tok))
                return
            if existing is None:
                self._node[(parent, key)] = page
                self._key[page] = (parent, key)
                self._nchild[page] = 0
                if parent:
                    self._nchild[parent] += 1
            parent = page
        if parent:
            self._first_tok.setdefault(parent, int(first_tok))

    def _reclaim_one(self) -> int:
        """Reclaim the LRU-oldest childless cached page."""
        for p in self._lru:
            if self._nchild.get(p, 0) == 0:
                del self._lru[p]
                parent, chunk = self._key.pop(p)
                del self._node[(parent, chunk)]
                del self._nchild[p]
                if parent:
                    self._nchild[parent] -= 1
                self._first_tok.pop(p, None)
                self.reclaimed += 1
                return p
        raise RuntimeError("reclaimable LRU holds no leaf: trie invariant "
                           "broken (a referenced child of a zero-ref parent)")


def kv_cache_bytes(cfg: ModelConfig, batch: int, max_len: int, *,
                   paged: Optional[T.PagedCacheConfig] = None,
                   cache_dtype=torch.bfloat16) -> int:
    """Bytes of self-attention KV cache state for this geometry (counted on
    the meta device: nothing is allocated)."""
    return kv_state_bytes(T.init_decode_state(
        cfg, batch, max_len, cache_dtype, paged=paged, device="meta"))


class _SchedulerBase:
    def __init__(self, params, cfg: ModelConfig, policy: Policy, *,
                 batch: int, max_len: int, eos_id: int = -1,
                 pad_id: int = 0, moe_impl: str = "dense", device="cuda"):
        self.params, self.cfg, self.policy = params, cfg, policy
        self.batch, self.max_len = batch, max_len
        self.eos_id, self.pad_id = eos_id, pad_id
        self.moe_impl = moe_impl
        self.device = device
        self.queue: List[Request] = []
        self.stats = ServeStats()

    def submit(self, req: Request):
        self.queue.append(req)

    def _count_nonfinite(self, logits, rows) -> None:
        """Add the ``rows`` of (B, V) ``logits`` that hold a NaN or inf."""
        finite = torch.isfinite(logits).all(-1).cpu().numpy()
        self.stats.nonfinite_logits += int(sum(not finite[i] for i in rows))


class CohortScheduler(_SchedulerBase):
    """Lockstep cohorts: up to ``batch`` queued prompts are left-padded with
    ``pad_id`` to the longest (no mask: pads are attended, as in the
    reference), prefilled together into a fresh contiguous cache and decoded
    together until every request hits EOS or its budget.  Finished slots
    keep decoding, their tokens discarded and counted as ``wasted_slots``;
    a short cohort is filled with dummy slots (``cohort[0].prompt``, budget
    0).  The cache is bf16 whatever the policy, as the reference's default
    ``cache_dtype``.  Latency counts from ``arrival_s``, so the wait for
    earlier cohorts is included.  An encoder-decoder is refused
    (``ValueError``): a cohort has no per-request frames."""

    def __init__(self, params, cfg: ModelConfig, policy: Policy, **kw):
        if cfg.decode_caps.cross_cache:
            raise ValueError(f"{cfg.arch_id}: the cohort scheduler has no "
                             "per-request encoder frames; serve an "
                             "encoder-decoder with ContinuousScheduler")
        super().__init__(params, cfg, policy, **kw)

    def _pad_prompts(self, reqs: List[Request]):
        plen = max(len(r.prompt) for r in reqs)
        toks = np.full((len(reqs), plen), self.pad_id, np.int32)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt
        return torch.from_numpy(toks).to(self.device), plen

    def run(self) -> List[Request]:
        done: List[Request] = []
        t0 = time.perf_counter()
        while self.queue:
            cohort = self.queue[: self.batch]
            self.queue = self.queue[self.batch:]
            self._run_cohort(cohort, t0)
            done.extend(cohort)
            self.stats.cohorts += 1
        self.stats.wall_s += time.perf_counter() - t0
        return done

    def _run_cohort(self, real: List[Request], t0: float):
        cohort = list(real)
        while len(cohort) < self.batch:
            cohort.append(Request(rid=-1, prompt=cohort[0].prompt,
                                  max_new_tokens=0))
        toks, plen = self._pad_prompts(cohort)
        budget = max(r.max_new_tokens for r in cohort)
        if plen + budget > self.max_len:
            raise ValueError(f"cohort prompt {plen} + max_new_tokens "
                             f"{budget} exceeds max_len {self.max_len}")
        state = T.init_decode_state(self.cfg, self.batch, self.max_len,
                                    torch.bfloat16, device=self.device)
        logits, state = T.prefill(self.params, toks, self.cfg, self.policy,
                                  state=state, moe_impl=self.moe_impl)
        tok = logits.argmax(-1)[:, None]
        outs = [tok[:, 0].cpu().numpy()]
        t_first = time.perf_counter() - t0
        alive = np.array([r.max_new_tokens > 0 for r in cohort])
        self._count_nonfinite(logits, np.flatnonzero(alive))
        finished_at = np.where(alive, budget, 0)
        done_at = np.full(self.batch, t_first)
        for i, r in enumerate(cohort):
            if alive[i]:
                r.first_token_s = t_first - r.arrival_s
                self.stats.useful_tokens += 1  # the prefill's first token
                if (self.eos_id >= 0 and outs[0][i] == self.eos_id) or \
                        r.max_new_tokens == 1:
                    alive[i] = False
                    finished_at[i] = 1
        for step in range(1, budget):
            if not alive.any():
                break
            n_active = int(alive.sum())
            t_step = time.perf_counter()
            logits, state = T.decode_step(self.params, tok, state, self.cfg,
                                          self.policy,
                                          moe_impl=self.moe_impl)
            tok = logits.argmax(-1)[:, None]
            col = tok[:, 0].cpu().numpy()
            self._count_nonfinite(logits, np.flatnonzero(alive))
            outs.append(col)
            self.stats.decode_steps += 1
            if self.stats.decode_steps > 1:  # the first step bears warm-up
                self.stats.decode_s += time.perf_counter() - t_step
                self.stats.decode_tokens += n_active
            now = time.perf_counter() - t0
            for i, r in enumerate(cohort):
                if not alive[i]:
                    self.stats.wasted_slots += 1
                    continue
                self.stats.useful_tokens += 1
                if (self.eos_id >= 0 and col[i] == self.eos_id) or \
                        step + 1 >= r.max_new_tokens:
                    alive[i] = False
                    finished_at[i] = step + 1
                    done_at[i] = now
        gen = np.stack(outs, axis=1)  # (B, steps)
        for i, r in enumerate(cohort):
            if r.rid < 0:
                continue
            n = int(finished_at[i])
            r.output = gen[i, :n].astype(np.int32) if n else \
                np.zeros((0,), np.int32)
            r.latency_s = max(float(done_at[i]) - r.arrival_s, 0.0)


class ContinuousScheduler(_SchedulerBase):
    """Slot-refilling scheduler: evict on EOS/budget, refill immediately.

    ``prefill_len`` is the right-padded prompt bucket; longer prompts keep
    their last ``prefill_len`` tokens.  See the module docstring for the
    cache modes, preemption, deadlines and the prefix cache.
    """

    def __init__(self, params, cfg: ModelConfig, policy: Policy, *,
                 batch: int, max_len: int, prefill_len: int = 32,
                 eos_id: int = -1, pad_id: int = 0,
                 moe_impl: str = "dense", cache_mode: str = "contiguous",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 cache_dtype=torch.bfloat16, prefix_cache: bool = False,
                 device="cuda"):
        super().__init__(params, cfg, policy, batch=batch, max_len=max_len,
                         eos_id=eos_id, pad_id=pad_id, moe_impl=moe_impl,
                         device=device)
        if prefill_len > max_len:
            raise ValueError(f"prefill_len {prefill_len} > max_len {max_len}")
        if cache_mode not in ("contiguous", "paged", "paged_int8"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        caps = cfg.decode_caps
        if cache_mode != "contiguous" and not caps.pageable:
            raise ValueError(
                "paged KV cache requires a pageable arch (every "
                "self-attention layer full-attention): sliding-window rings "
                "and attention-free state cannot be paged -- serve "
                f"{cfg.arch_id} with cache_mode='contiguous'")
        if prefix_cache and cache_mode == "contiguous":
            raise ValueError("prefix_cache requires a paged cache_mode "
                             "(sharing works at page granularity)")
        if prefix_cache and not caps.prefix_shareable:
            raise ValueError(
                "prefix_cache requires prefix_shareable: the cache must be "
                "a pure function of prompt token ids (recurrent state, "
                "encoder frames and vision embeds all break the token-hash "
                f"index) -- not satisfied by {cfg.arch_id}")
        if caps.windowed and prefill_len > cfg.sliding_window:
            # the reference asserts this at the first slot prefill
            raise ValueError(f"prefill_len {prefill_len} exceeds the "
                             f"sliding window {cfg.sliding_window}: a slot "
                             "prefill cannot roll a ring")
        self.prefill_len = prefill_len
        self.cache_mode = cache_mode
        self.cache_dtype = cache_dtype
        self.page_size = page_size
        self.prefix_cache = prefix_cache
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
            self.allocator = PageAllocator(self.num_pages,
                                           page_size=page_size,
                                           prefix_cache=prefix_cache)
        # rids whose decode a preemption restarted (their outputs may
        # differ from an uninterrupted run's: the re-prefill truncates
        # prompt + generated tokens to the bucket)
        self.preempted_rids: set = set()
        self.adapter = SlotStateAdapter(
            params, cfg, policy, batch=batch, max_len=max_len,
            cache_dtype=cache_dtype, paged_cfg=self.paged_cfg,
            moe_impl=moe_impl, device=device)
        self.stats.cache_bytes = self.adapter.cache_bytes()
        self.stats.state_bytes = self.adapter.state_bytes()

    def submit(self, req: Request):
        if self.cfg.decode_caps.cross_cache and req.enc_frames is None:
            raise ValueError(
                f"request {req.rid}: {self.cfg.arch_id} is an "
                "encoder-decoder; submit() needs enc_frames (enc_seq, "
                "d_model) to fill the slot's cross-attention cache at "
                "admission")
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
        super().submit(req)

    def _bucket(self, prompt: np.ndarray):
        """Right-pad (or left-truncate) a prompt to the prefill bucket."""
        p = self.prefill_len
        prompt = np.asarray(prompt, np.int32)[-p:]
        toks = np.full((1, p), self.pad_id, np.int32)
        toks[0, : len(prompt)] = prompt
        return torch.from_numpy(toks).to(self.device), len(prompt)

    def _match(self, ptoks: np.ndarray, length: int):
        """The prefix cache's admission: (shared pages, covered tokens,
        cached first token or None) for a prompt of ``length`` tokens."""
        self.stats.prefix_lookups += 1
        shared, covered, ftok = self.allocator.match_prefix(ptoks)
        if shared and covered == length and ftok is None:
            # a page-aligned full match with no cached first token (the
            # node was interior to every registration): run the last chunk
            # as a suffix into a private page; registering it caches the
            # token, so the next identical prompt is a full hit
            shared = shared[:-1]
            covered = len(shared) * self.page_size
        if shared and covered < length and \
                covered + self.prefill_len > self.max_len:
            # the suffix bucket would overrun the cache extent: a full
            # private prefill instead
            shared, covered, ftok = [], 0, None
        # a partial last chunk matches only exactly, and then it is a full
        # hit: every suffix starts on a page boundary
        assert covered == length or covered % self.page_size == 0
        return shared, covered, ftok

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
        ps = self.page_size

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
            self.preempted_rids.add(req.rid)
            resume[req.rid] = (
                np.concatenate([np.asarray(slot_prompt[i], np.int32),
                                np.asarray(gens[i], np.int32)]),
                slot_budget[i] - len(gens[i]),
                prefix[i] + gens[i])
            pending.insert(0, req)
            self.stats.preemptions += 1
            release(i)

        def preempt_youngest():
            active = [j for j in range(self.batch) if slots[j] is not None]
            preempt(max(active, key=lambda j: admit_seq[j]))

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
                    ptoks = np.asarray(prompt, np.int32)[-self.prefill_len:]
                    shared: List[int] = []
                    covered, ftok = 0, None
                    if self.allocator is not None:
                        # pages for the prompt + the first decode write
                        need = -(-(length + 1) // ps)
                        if self.prefix_cache:
                            shared, covered, ftok = self._match(ptoks, length)
                        # ref the matched chain before alloc, which must not
                        # reclaim pages this admission is about to map
                        self.allocator.ref(shared)
                        pages = self.allocator.alloc(need - len(shared))
                        if pages is None:
                            if shared:
                                self.allocator.free(shared)
                            resume.setdefault(req.rid,
                                              (prompt, budget, out_prefix))
                            break  # pool dry: wait for an eviction
                        slot_pages[i] = list(shared) + pages
                        state = self.adapter.write_table_row(state, i,
                                                             slot_pages[i])
                    pending.pop(0)
                    if shared:
                        self.stats.prefix_hits += 1
                        self.stats.pages_shared += len(shared)
                        self.stats.prefill_tokens_saved += covered
                    if shared and covered == length:
                        # full hit: every prompt token is in cached pages and
                        # the first greedy token is cached with the end node;
                        # no prefill, the slot's position just moves on
                        self.stats.prefix_full_hits += 1
                        state["pos"][i] = length
                        tok0 = int(ftok)
                    else:
                        if covered:
                            stoks = np.full((1, self.prefill_len),
                                            self.pad_id, np.int32)
                            sfx = ptoks[covered:]
                            stoks[0, : len(sfx)] = sfx
                            logits, state = self.adapter.prefill(
                                state, torch.from_numpy(stoks).to(
                                    self.device), length - covered, i,
                                start=covered)
                        else:
                            frames = None if req.enc_frames is None else \
                                torch.as_tensor(np.asarray(
                                    req.enc_frames, np.float32)
                                )[None].to(self.device)
                            logits, state = self.adapter.prefill(
                                state, toks, length, i, enc_frames=frames)
                        self.stats.prefill_tokens += length - covered
                        self.stats.prefills += 1
                        if not bool(torch.isfinite(logits).all()):
                            self.stats.nonfinite_logits += 1
                        tok0 = int(logits.argmax())
                        if self.prefix_cache:
                            self.allocator.register_prefix(
                                ptoks, slot_pages[i][: -(-length // ps)],
                                tok0)
                    self.stats.useful_tokens += 1
                    now = time.perf_counter() - t0
                    if not req.first_token_s:  # kept across preemptions
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
            if self.allocator is not None:
                for i in range(self.batch):
                    # --- grow slots crossing a page boundary this step ---
                    while slots[i] is not None and \
                            kv_next[i] // ps >= len(slot_pages[i]):
                        pg = self.allocator.alloc(1)
                        if pg is not None:
                            slot_pages[i].append(pg[0])
                            state = self.adapter.write_table_row(
                                state, i, slot_pages[i])
                            continue
                        preempt_youngest()
                    # --- copy-on-write: this step writes into a page a
                    # sibling also maps (e.g. the partial last page of a
                    # shared prompt), so copy it to a private page and
                    # repoint the table before the write.  A preemption in
                    # this loop may itself leave the page unshared ---
                    while slots[i] is not None and self.allocator.refcount(
                            slot_pages[i][kv_next[i] // ps]) > 1:
                        pg = self.allocator.alloc(1)
                        if pg is None:
                            preempt_youngest()
                            continue
                        pi = kv_next[i] // ps
                        old = slot_pages[i][pi]
                        state = self.adapter.copy_page(state, old, pg[0],
                                                       kv_next[i] % ps)
                        slot_pages[i][pi] = pg[0]
                        state = self.adapter.write_table_row(state, i,
                                                             slot_pages[i])
                        self.allocator.free([old])
                        self.stats.cow_copies += 1
                if not any(s is not None for s in slots):
                    continue  # everyone preempted: back to admission
            # --- one decode step for the whole batch, slots independent ---
            n_active = sum(s is not None for s in slots)
            t_step = time.perf_counter()
            logits, state = T.decode_step(
                self.params, torch.from_numpy(cur).to(self.device), state,
                self.cfg, self.policy, moe_impl=self.moe_impl)
            col = logits.argmax(-1).cpu().numpy()
            self._count_nonfinite(
                logits, [i for i in range(self.batch) if slots[i] is not None])
            self.stats.decode_steps += 1
            if self.stats.decode_steps > 1:  # the first step bears warm-up
                self.stats.decode_s += time.perf_counter() - t_step
                self.stats.decode_tokens += n_active
            now = time.perf_counter() - t0
            for i in range(self.batch):
                if slots[i] is None:
                    self.stats.wasted_slots += 1
                    continue
                self.stats.useful_tokens += 1
                kv_next[i] += 1
                gens[i].append(int(col[i]))
                cur[i, 0] = int(col[i])
                if (self.eos_id >= 0 and col[i] == self.eos_id) or \
                        len(gens[i]) >= slot_budget[i]:
                    finish(i, now)
        self.stats.wall_s += time.perf_counter() - t0
        return done
