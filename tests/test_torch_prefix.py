"""The port's prefix cache against the JAX package at f32: the suffix
prefill into a paged slot, the copy-on-write page copy, the refcounted page
trie, and ``ContinuousScheduler(prefix_cache=True)`` on a shared-prefix
trace, on the same weights; plus twins of the reference's own prefix
tests (``tests/test_prefix.py``) on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.amp import make_policy as jmake_policy
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import scheduler as JS
from repro.serve import serve_step as JSS
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import scheduler as S
from repro_torch.serve import serve_step as SS
from test_torch_scheduler import INT8_LOGIT_BOUND, LOGIT_TOL
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

JCFG = jsmoke(jget_config("deepseek-7b"), n_blocks=2)
CFG = smoke_variant(get_config("deepseek-7b"), n_blocks=2)
JPOL, POL = jmake_policy("f32"), make_policy("f32")
# a suffix prefill against the whole prompt's prefill (the reference's own
# bounds, tests/test_prefix.py): f32 pages differ by summation order, int8
# pages also by the head's KV read back quantised
SUFFIX_TOL = {False: 2e-3, True: 0.05}
# ServeStats fields that count events (the rest are seconds and bytes)
COUNTERS = ("cohorts", "prefills", "decode_steps", "useful_tokens",
            "wasted_slots", "preemptions", "timeouts", "decode_tokens",
            "prefix_lookups", "prefix_hits", "prefix_full_hits",
            "prefill_tokens", "prefill_tokens_saved", "pages_shared",
            "cow_copies")


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(lambda key: JT.init_model(key, JCFG)[0])(
        jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return jp, bridge.params_from_jax(np_params, CFG, device="cpu")


def _bucketed(tokens, width):
    t = np.zeros((1, width), np.int32)
    t[0, : len(tokens)] = tokens
    return t


def _dequant(cache, key, scale):
    pages = np.asarray(cache[key], np.float32)
    if scale in cache:
        pages = pages * np.asarray(cache[scale])[..., None, :, None]
    return pages


@pytest.mark.parametrize("quantized", [False, True], ids=["paged", "int8"])
def test_suffix_prefill_matches_jax_and_whole_prefill(weights, quantized):
    """Slot 0 takes a 13-token prompt whole; slot 1 takes its first page as
    a prefill and the rest as a suffix prefill at start 8.  Every call's
    logits, the pools, scales and positions equal the reference's; the
    suffix's logits and 4 decode steps of both slots agree with the whole
    prefill's within the reference's bounds."""
    jp, tp = weights
    max_len, ps, plen, cut = 48, 8, 13, 8
    prompt = np.random.default_rng(1).integers(
        0, CFG.vocab_size, plen).astype(np.int32)
    jstate = JT.init_decode_state(JCFG, 2, max_len, jnp.float32, paged=(
        JT.PagedCacheConfig(page_size=ps, num_pages=13, quantized=quantized)))
    tstate = T.init_decode_state(CFG, 2, max_len, torch.float32, paged=(
        T.PagedCacheConfig(page_size=ps, num_pages=13, quantized=quantized)),
        device="cpu")
    rows = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
    jstate = JT.set_block_tables(jstate, rows)
    T.set_block_tables(tstate, rows)
    bound = (dict(rtol=0, atol=INT8_LOGIT_BOUND) if quantized
             else LOGIT_TOL)
    calls = [(prompt, 16, plen, 0, None), (prompt[:cut], cut, cut, 1, None),
             (prompt[cut:], 16, plen - cut, 1, cut)]
    logits = []
    for toks, width, length, slot, start in calls:
        t = _bucketed(toks, width)
        jl, jstate = JSS.prefill_into_slot(jp, jnp.asarray(t), length,
                                           jstate, slot, JCFG, JPOL,
                                           start=start)
        tl, tstate = SS.prefill_into_slot(tp, torch.from_numpy(t), length,
                                          tstate, slot, CFG, POL,
                                          start=start)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **bound)
        logits.append(tl)
    assert tstate["pos"].tolist() == [plen, plen]
    assert np.asarray(jstate["pos"]).tolist() == [plen, plen]
    jc = jstate["blocks"][0]["cache"]
    for layer, st in enumerate(tstate["blocks"]):
        tc = {k: t.numpy() for k, t in st["cache"].items()}
        for key, scale in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
            got = _dequant(tc, key, scale)
            want = _dequant({k: v[layer] for k, v in jc.items()}, key, scale)
            # int8: a rounding tie flipped by fp noise moves one int
            atol = (float(np.asarray(jc[scale][layer]).max()) * 1.001
                    if quantized else 1e-5)
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=f"layer {layer} {key}")
    tol = SUFFIX_TOL[quantized]
    np.testing.assert_allclose(logits[2].numpy(), logits[0].numpy(),
                               rtol=tol, atol=tol)
    cur = np.full((2, 1), int(logits[0].argmax()), np.int64)
    for _ in range(4):  # both slots decode the same continuation
        lg, tstate = T.decode_step(tp, torch.from_numpy(cur), tstate, CFG,
                                   POL)
        np.testing.assert_allclose(lg[1].numpy(), lg[0].numpy(), rtol=tol,
                                   atol=tol)
        if not quantized:
            assert int(lg[0].argmax()) == int(lg[1].argmax())
        cur[:, 0] = int(lg[0].argmax())


def test_suffix_prefill_refusals(weights):
    _, tp = weights
    paged = T.init_decode_state(CFG, 1, 32, torch.float32, device="cpu",
                                paged=T.PagedCacheConfig(8, 5))
    contiguous = T.init_decode_state(CFG, 1, 32, torch.float32,
                                     device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="paged"):
        SS.prefill_into_slot(tp, toks, 4, contiguous, 0, CFG, POL, start=8)
    with pytest.raises(ValueError, match="page-aligned"):
        SS.prefill_into_slot(tp, toks, 4, paged, 0, CFG, POL, start=4)
    with pytest.raises(ValueError, match="extent"):
        SS.prefill_into_slot(tp, toks, 4, paged, 0, CFG, POL, start=32)
    rwkv = smoke_variant(get_config("rwkv6-1.6b"))
    with pytest.raises(ValueError, match="attention-only"):
        T.prefill_suffix({}, toks, 8, 4, rwkv, POL, state={})


@pytest.mark.parametrize("quantized", [False, True], ids=["paged", "int8"])
def test_copy_page_cow_matches_jax(quantized):
    """The copy of page 1 into page 3 keeping 3 rows, layer by layer on the
    port's per-layer pools against the reference's stacked pool: pages and
    scales equal, every other page untouched."""
    rng = np.random.default_rng(0)
    nb, pool, ps, kv, dh = 2, 4, 4, 2, 8
    if quantized:
        pages = rng.integers(-20, 21, (nb, pool, ps, kv, dh)).astype(np.int8)
        pages[:, 1, 3] = 127             # a dead row at full scale
        scales = rng.uniform(0.1, 1.0, (nb, pool, kv)).astype(np.float32)
        jc = {"k_pages": pages, "v_pages": pages[:, ::-1].copy(),
              "k_scale": scales, "v_scale": scales[:, ::-1].copy()}
    else:
        jc = {k: rng.normal(size=(nb, pool, ps, kv, dh)).astype(np.float32)
              for k in ("k_pages", "v_pages")}
    want = JL.copy_page_cow({k: jnp.asarray(v) for k, v in jc.items()},
                            1, 3, 3)
    for layer in range(nb):
        tc = {k: torch.from_numpy(v[layer].copy()) for k, v in jc.items()}
        got = L.copy_page_cow(tc, 1, 3, 3)
        assert got is tc
        for k, v in tc.items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(want[k][layer]),
                                          err_msg=f"layer {layer} {k}")
        untouched = [0, 1, 2]
        for k in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(tc[k].numpy()[untouched],
                                          jc[k][layer][untouched])
        assert not tc["k_pages"][3, 3:].any()


def test_allocator_matches_jax_on_a_seeded_sequence():
    """One seeded sequence of alloc / ref / free / match_prefix /
    register_prefix through both allocators (a 17-page pool, pages of 4,
    a 5-token vocabulary for frequent collisions): every return and every
    counter equal after each operation, reclaim included."""
    rng = np.random.default_rng(7)
    ps = 4
    ja = JS.PageAllocator(17, page_size=ps, prefix_cache=True)
    ta = S.PageAllocator(17, page_size=ps, prefix_cache=True)
    live = []      # page lists held by "slots"

    def same_counters():
        for name in ("available", "cached", "in_use", "reclaimed"):
            assert getattr(ta, name) == getattr(ja, name), name
        for p in range(17):
            assert ta.refcount(p) == ja.refcount(p), p

    for _ in range(600):
        if live and rng.random() < 0.4:
            pages = live.pop(int(rng.integers(len(live))))
            ja.free(pages)
            ta.free(pages)
        else:
            toks = rng.integers(0, 5, size=int(rng.integers(1, 3 * ps + 1)),
                                dtype=np.int32)
            jm, tm = ja.match_prefix(toks), ta.match_prefix(toks)
            assert tm == jm
            shared = tm[0]
            ja.ref(shared)
            ta.ref(shared)
            n = -(-(len(toks) + 1) // ps) - len(shared)
            jp, tp = ja.alloc(n), ta.alloc(n)
            assert tp == jp
            if tp is None:
                ja.free(shared)
                ta.free(shared)
            else:
                pages = list(shared) + tp
                tok = int(rng.integers(5))
                cover = pages[: -(-len(toks) // ps)]
                ja.register_prefix(toks, cover, tok)
                ta.register_prefix(toks, cover, tok)
                live.append(pages)
        same_counters()
    assert ta.reclaimed > 0
    for pages in live:
        ja.free(pages)
        ta.free(pages)
    same_counters()
    assert ta.in_use == 0 and ta.available == 16
    with pytest.raises(ValueError):
        ta.free([0])
    with pytest.raises(ValueError):
        S.PageAllocator(1)


# --- twins of tests/test_prefix.py on the port -----------------------------

def test_allocator_reclaims_cached_leaves_before_refusing():
    ps = 4
    alloc = S.PageAllocator(9, page_size=ps, prefix_cache=True)
    toks = np.arange(3 * ps, dtype=np.int32)   # 3-page chain
    pages = alloc.alloc(3)
    alloc.register_prefix(toks, pages, 7)
    alloc.free(pages)                          # chain parked in the LRU
    assert alloc.cached == 3 and alloc.available == 8
    got = alloc.alloc(7)                       # needs 2 reclaims
    assert got is not None and alloc.reclaimed == 2
    assert alloc.cached == 1                   # leaf first: the root stays
    m, covered, _ = alloc.match_prefix(toks)
    assert covered == ps
    with pytest.raises(ValueError):
        alloc.free([m[0]])                     # zero-ref cached page


def test_allocator_full_hit_returns_first_token():
    ps = 4
    alloc = S.PageAllocator(9, page_size=ps, prefix_cache=True)
    toks = np.asarray([1, 2, 3, 4, 5, 6], np.int32)   # partial last chunk
    pages = alloc.alloc(2)
    alloc.register_prefix(toks, pages, first_tok=42)
    m, covered, ftok = alloc.match_prefix(toks)
    assert m == pages and covered == 6 and ftok == 42
    # a longer prompt sharing the partial tokens does not match the
    # partial node (its page holds only 2 tokens of KV there)
    _, covered2, ftok2 = alloc.match_prefix(
        np.asarray([1, 2, 3, 4, 5, 6, 7, 8, 9], np.int32))
    assert covered2 == ps and ftok2 is None


def test_full_hit_skips_prefill_but_records_ttft(weights):
    _, tp = weights
    sched = S.ContinuousScheduler(
        tp, CFG, POL, batch=2, max_len=72, prefill_len=32,
        cache_mode="paged", page_size=16, prefix_cache=True,
        cache_dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(2).integers(0, CFG.vocab_size, size=23,
                                               dtype=np.int32)
    for i in range(4):
        sched.submit(S.Request(rid=i, prompt=prompt, max_new_tokens=4,
                               arrival_s=0.05 * i))
    done = sched.run()
    assert sched.stats.prefix_full_hits >= 1
    assert sched.stats.prefills < len(done)
    for r in done:
        assert 0.0 < r.first_token_s <= r.latency_s + 1e-9
    for r in done[1:]:
        np.testing.assert_array_equal(r.output[: len(done[0].output)],
                                      done[0].output[: len(r.output)])


def test_starved_pool_reclaims_cached_pages_before_preempting(weights):
    _, tp = weights
    sched = S.ContinuousScheduler(
        tp, CFG, POL, batch=2, max_len=48, prefill_len=16,
        cache_mode="paged", page_size=8, num_pages=13, prefix_cache=True,
        cache_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    heads = [rng.integers(0, CFG.vocab_size, size=8, dtype=np.int32)
             for _ in range(3)]
    for i in range(9):
        prompt = np.concatenate(
            [heads[i % 3], rng.integers(0, CFG.vocab_size, size=5,
                                        dtype=np.int32)])
        sched.submit(S.Request(rid=i, prompt=prompt, max_new_tokens=6))
    assert len(sched.run()) == 9
    assert sched.allocator.reclaimed > 0
    assert sched.stats.preemptions == 0
    assert sched.allocator.in_use == 0


# --- the scheduler on a shared-prefix trace --------------------------------

def _shared_trace(n=10, seed=0, head_len=20, repeats=2):
    """The reference test's trace: two groups sharing a 20-token head; the
    last ``repeats`` are exact repeats of one 27-token prompt (a full hit
    and copy-on-write)."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, CFG.vocab_size, size=head_len, dtype=np.int32)
             for _ in range(2)]
    dup = np.concatenate(
        [heads[0], rng.integers(0, CFG.vocab_size, size=7, dtype=np.int32)])
    out = []
    for i in range(n):
        prompt = dup if i >= n - repeats else np.concatenate(
            [heads[i % 2], rng.integers(0, CFG.vocab_size,
                                        size=int(rng.integers(2, 13)),
                                        dtype=np.int32)])
        out.append((prompt, int(rng.integers(4, 9))))
    return out


def _run(mod, params, cfg, pol, mode, prefix_cache, **kw):
    sched = mod.ContinuousScheduler(
        params, cfg, pol, batch=4, max_len=72, prefill_len=32,
        cache_mode=mode, page_size=16, prefix_cache=prefix_cache, **kw)
    for i, (prompt, new) in enumerate(_shared_trace()):
        sched.submit(mod.Request(rid=i, prompt=prompt, max_new_tokens=new))
    return sched, {r.rid: r.output.tolist() for r in sched.run()}


@pytest.mark.parametrize("mode", ["paged", "paged_int8"])
def test_shared_prefix_scheduler_matches_jax(weights, mode):
    """Outputs per rid and every ServeStats counter equal to the
    reference scheduler's on the shared trace (partial hits, a full hit and
    copy-on-write all taken); every page comes back.  In ``paged`` the
    shared run's tokens also equal the port's own unshared run's."""
    jp, tp = weights
    jsched, want = _run(JS, jp, JCFG, JPOL, mode, True,
                        cache_dtype=jnp.float32)
    tsched, got = _run(S, tp, CFG, POL, mode, True,
                       cache_dtype=torch.float32, device="cpu")
    assert got == want
    for name in COUNTERS:
        assert getattr(tsched.stats, name) == getattr(jsched.stats, name), \
            name
    st = tsched.stats
    assert st.prefix_hits > 0 and st.prefix_full_hits > 0
    assert st.cow_copies > 0 and st.prefill_tokens_saved > 0
    assert st.nonfinite_logits == 0
    assert tsched.allocator.in_use == 0
    assert tsched.allocator.available == tsched.num_pages - 1
    if mode == "paged":
        base, unshared = _run(S, tp, CFG, POL, mode, False,
                              cache_dtype=torch.float32, device="cpu")
        assert st.prefill_tokens < base.stats.prefill_tokens
        assert got == unshared


def test_prefix_cache_refusals(weights):
    _, tp = weights
    with pytest.raises(ValueError, match="paged"):
        S.ContinuousScheduler(tp, CFG, POL, batch=1, max_len=32,
                              prefill_len=16, prefix_cache=True,
                              device="cpu")
    rwkv = smoke_variant(get_config("rwkv6-1.6b"))
    with pytest.raises(ValueError):
        S.ContinuousScheduler({}, rwkv, POL, batch=1, max_len=32,
                              prefill_len=16, cache_mode="paged",
                              prefix_cache=True, device="cpu")
