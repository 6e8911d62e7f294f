"""Single-slot prefill into contiguous / paged / int8-paged caches and
``ContinuousScheduler`` outputs of the port against the JAX package at f32,
on the same weights and one seeded trace."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.amp import make_policy as jmake_policy
from repro.models import transformer as JT
from repro.serve import scheduler as JS
from repro.serve import serve_step as JSS
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import transformer as T
from repro_torch.serve import scheduler as S
from repro_torch.serve import serve_step as SS
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

JCFG = jsmoke(jget_config("deepseek-7b"), n_blocks=2)
CFG = smoke_variant(get_config("deepseek-7b"), n_blocks=2)
JPOL, POL = jmake_policy("f32"), make_policy("f32")
# f32 logits of a 2-layer model: the two frameworks differ only in
# summation order (measured ~1e-6); 1e-4 leaves room for other BLAS builds
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# int8 pages: both sides quantise the same values with the same rounding
# (half to even), so only an fp-noise flip of a rounding tie separates them;
# one flipped int moves a logit by far less than the reference's own
# int8-vs-float bound of 0.05 (tests/test_paged.py)
INT8_LOGIT_BOUND = 1e-2


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(lambda key: JT.init_model(key, JCFG)[0])(
        jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return jp, bridge.params_from_jax(np_params, CFG, device="cpu")


@pytest.mark.parametrize("mode", ["contiguous", "paged", "paged_int8"])
def test_prefill_into_slot_matches_jax(weights, mode):
    """One request prefilled into slot 1 of a live 2-slot state (its
    neighbour untouched), then 4 decode steps; paged modes write through
    the slot's block-table row."""
    jp, tp = weights
    bucket, max_len, ps = 16, 24, 4
    paged = mode != "contiguous"
    jpaged = tpaged = None
    if paged:
        jpaged = JT.PagedCacheConfig(page_size=ps, num_pages=13,
                                     quantized=mode == "paged_int8")
        tpaged = T.PagedCacheConfig(page_size=ps, num_pages=13,
                                    quantized=mode == "paged_int8")
    jstate = JT.init_decode_state(JCFG, 2, max_len, jnp.float32,
                                  paged=jpaged)
    tstate = T.init_decode_state(CFG, 2, max_len, torch.float32,
                                 paged=tpaged, device="cpu")
    if paged:
        rows = np.asarray([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]],
                          np.int32)
        jstate = JT.set_block_tables(jstate, rows)
        T.set_block_tables(tstate, rows)
    rng = np.random.default_rng(11)
    toks = np.zeros((1, bucket), np.int32)
    length = 11
    toks[0, :length] = rng.integers(0, CFG.vocab_size, length)
    jl, jstate = JSS.prefill_into_slot(jp, jnp.asarray(toks), length, jstate,
                                       1, JCFG, JPOL)
    tl, tstate = SS.prefill_into_slot(tp, torch.from_numpy(toks), length,
                                      tstate, 1, CFG, POL)
    assert tstate["pos"].tolist() == [0, length]
    cache = tstate["blocks"][0]["cache"]
    # the neighbour's stripe / pages are untouched
    assert not (cache["k_pages"][1:7] if paged else cache["k"][0]).any()
    bound = (dict(rtol=0, atol=INT8_LOGIT_BOUND) if mode == "paged_int8"
             else LOGIT_TOL)
    cur = np.zeros((2, 1), np.int32)
    jrow, trow = np.asarray(jl), tl
    for _ in range(4):
        np.testing.assert_allclose(trow.numpy(), jrow, **bound)
        cur[1, 0] = int(np.argmax(jrow))
        jl, jstate = JT.decode_step(jp, jnp.asarray(cur), jstate, JCFG, JPOL)
        tl, tstate = T.decode_step(tp, torch.from_numpy(cur), tstate, CFG,
                                   POL)
        jrow, trow = np.asarray(jl)[1], tl[1]
    np.testing.assert_allclose(trow.numpy(), jrow, **bound)


def _trace(seed=5, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab_size, int(rng.integers(3, 21)))
             .astype(np.int32), int(rng.integers(2, 8))) for _ in range(n)]


@pytest.mark.parametrize("mode", ["contiguous", "paged", "paged_int8"])
def test_scheduler_matches_jax(weights, mode):
    """Per-request tokens of ContinuousScheduler identical to the JAX
    scheduler's on one seeded trace.  The paged pool (10 pages for 2 slots
    of up to 8) is small enough to force preemptions, which both must take
    at the same steps; every page comes back."""
    jp, tp = weights
    kw = dict(batch=2, max_len=32, prefill_len=24, cache_mode=mode,
              page_size=4, num_pages=None if mode == "contiguous" else 11)
    jsched = JS.ContinuousScheduler(jp, JCFG, JPOL, cache_dtype=jnp.float32,
                                    **kw)
    tsched = S.ContinuousScheduler(tp, CFG, POL, cache_dtype=torch.float32,
                                   device="cpu", **kw)
    for i, (prompt, new) in enumerate(_trace()):
        jsched.submit(JS.Request(rid=i, prompt=prompt, max_new_tokens=new))
        tsched.submit(S.Request(rid=i, prompt=prompt, max_new_tokens=new))
    want = {r.rid: r.output.tolist() for r in jsched.run()}
    got = {r.rid: r.output.tolist() for r in tsched.run()}
    assert got == want
    assert tsched.stats.preemptions == jsched.stats.preemptions
    assert tsched.stats.useful_tokens == jsched.stats.useful_tokens
    assert tsched.stats.nonfinite_logits == 0
    if mode != "contiguous":
        assert tsched.stats.preemptions > 0
        assert tsched.allocator.in_use == 0
        assert tsched.allocator.available == tsched.num_pages - 1


def test_cache_bytes_match_jax_accounting():
    """KV bytes from tensor sizes: the same stripes, pages and scales as
    the reference; the port keeps one block table for all layers where the
    reference stacks one per layer."""
    for mode, q in (("paged", False), ("paged_int8", True)):
        jb = JS.kv_cache_bytes(JCFG, 2, 32, paged=JT.PagedCacheConfig(
            page_size=4, num_pages=17, quantized=q), cache_dtype=jnp.float32)
        tb = S.kv_cache_bytes(CFG, 2, 32, paged=T.PagedCacheConfig(
            page_size=4, num_pages=17, quantized=q),
            cache_dtype=torch.float32)
        table = 2 * 8 * 4
        assert tb == jb - (CFG.n_layers - 1) * table, mode
    assert S.kv_cache_bytes(CFG, 2, 32, cache_dtype=torch.float32) == \
        JS.kv_cache_bytes(JCFG, 2, 32, cache_dtype=jnp.float32)


def test_deadline_and_allocator_invariants(weights):
    _, tp = weights
    sched = S.ContinuousScheduler(tp, CFG, POL, batch=2, max_len=32,
                                  prefill_len=16, cache_mode="paged",
                                  page_size=4, cache_dtype=torch.float32,
                                  device="cpu")
    prompt = np.arange(5, dtype=np.int32)
    sched.submit(S.Request(rid=0, prompt=prompt, max_new_tokens=4,
                           deadline_s=0.0))
    sched.submit(S.Request(rid=1, prompt=prompt, max_new_tokens=4))
    done = {r.rid: r for r in sched.run()}
    assert done[0].timed_out and len(done[0].output) == 0
    assert len(done[1].output) == 4 and not done[1].timed_out
    assert sched.stats.timeouts == 1 and sched.allocator.in_use == 0
    alloc = S.PageAllocator(4)
    pages = alloc.alloc(3)
    assert 0 not in pages and alloc.alloc(1) is None
    alloc.free(pages)
    with pytest.raises(ValueError):
        alloc.free(pages[:1])
    with pytest.raises(ValueError):
        S.ContinuousScheduler(tp, CFG, POL, batch=1, max_len=8,
                              prefill_len=16, device="cpu")
