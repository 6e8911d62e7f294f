"""qwen2-vl-7b served by the port against the JAX package, at
``smoke_variant`` sizes (``tests/torch_qwen2vl.py``), in f32:

* its row of the capability matrix and the adapter's footprints;
* a slot prefill (text only, as the reference's scheduler sends it:
  M-RoPE at ``arange`` on the three axes) and 4 decode steps, in every
  cache mode;
* ``ContinuousScheduler`` in ``paged`` and ``paged_int8``, text only:
  every request's tokens equal the reference scheduler's (a small pool
  forcing preemptions) and, on f32 pages, the reference's
  ``greedy_generate`` of each request; ``CohortScheduler`` likewise;
* the prefix cache refused with the reference's reason;
* a raw prefill with vision embeddings and greedy generation with them
  against the reference's ``prefill(vision_embeds=)`` and
  ``greedy_generate``; the embeddings move the logits;
* the serve CLI's modes, its vision embeddings and its refusals."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serve import scheduler as JS
from repro.serve import serve_step as JSS
from repro.serve.slot_state import SlotStateAdapter as JAdapter
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serve import scheduler as S
from repro_torch.serve import serve_step as SS
from repro_torch.serve.slot_state import SlotStateAdapter
from torch_qwen2vl import (ARCH, JPOL, LOGIT_TOL, POL, model, rel_l2,
                           tokens, vision)
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

# int8 pages: the same values quantised with the same rounding on both
# sides (tests/test_torch_scheduler.py)
INT8_LOGIT_BOUND = 1e-2
MAX_LEN = 32


def test_capability_row_and_footprints():
    """qwen2-vl's row (pageable, not prefix-shareable: its caches depend
    on vision embeddings wherever they are given; no recurrent rows, no
    cross cache), the reference's; no per-slot state beside the KV, whose
    footprint equals the reference adapter's, contiguous and paged -- but
    for the block tables: the port's layers share one, the reference
    stacks one a layer."""
    jcfg, cfg, jp, tp = model()
    c = cfg.decode_caps
    assert (c.pageable, c.prefix_shareable, c.needs_exact_prefill,
            c.constant_state, c.windowed, c.cross_cache) == (
        True, False, False, False, False, False)
    for paged in (None, T.PagedCacheConfig(page_size=4, num_pages=17)):
        ad = SlotStateAdapter(tp, cfg, POL, batch=2, max_len=MAX_LEN,
                              paged_cfg=paged, device="cpu")
        jpaged = None if paged is None else JT.PagedCacheConfig(
            page_size=4, num_pages=17)
        jad = JAdapter(jp, jcfg, JPOL, batch=2, max_len=MAX_LEN,
                       paged_cfg=jpaged)
        tables = 0 if paged is None else \
            (cfg.n_layers - 1) * 2 * ad.max_pages * 4
        assert ad.state_bytes() == jad.state_bytes() == 0
        assert ad.cache_bytes() + tables == jad.cache_bytes() > 0


@functools.lru_cache(maxsize=None)
def _jdecode():
    jcfg = model()[0]
    return jax.jit(functools.partial(JT.decode_step, cfg=jcfg, policy=JPOL))


@pytest.mark.parametrize("mode", ["contiguous", "paged", "paged_int8"])
def test_prefill_into_slot_matches_the_reference(mode):
    """One 14-token request (text only) prefilled into slot 1 of a live
    2-slot state (bucket 16), then 4 decode steps at the slot's own
    position on the three axes; logits within LOGIT_TOL
    (INT8_LOGIT_BOUND for int8 pages), the neighbour slot untouched."""
    jcfg, cfg, jp, tp = model()
    bucket, max_len, ps, length = 16, 24, 4, 14
    jpaged = tpaged = None
    if mode != "contiguous":
        jpaged = JT.PagedCacheConfig(page_size=ps, num_pages=13,
                                     quantized=mode == "paged_int8")
        tpaged = T.PagedCacheConfig(page_size=ps, num_pages=13,
                                    quantized=mode == "paged_int8")
    jstate = JT.init_decode_state(jcfg, 2, max_len, jnp.float32,
                                  paged=jpaged)
    tstate = T.init_decode_state(cfg, 2, max_len, torch.float32,
                                 paged=tpaged, device="cpu")
    if tpaged is not None:
        rows = np.asarray([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]],
                          np.int32)
        jstate = JT.set_block_tables(jstate, rows)
        T.set_block_tables(tstate, rows)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :length] = tokens(cfg, (length,), 21)
    jl, jstate = JSS.prefill_into_slot(jp, jnp.asarray(toks), length, jstate,
                                       1, jcfg, JPOL)
    tl, tstate = SS.prefill_into_slot(tp, torch.from_numpy(toks), length,
                                      tstate, 1, cfg, POL)
    assert tstate["pos"].tolist() == [0, length]
    cache = tstate["blocks"][0]["cache"]
    assert not (cache["k_pages"][1:7] if tpaged else cache["k"][0]).any()
    bound = (dict(rtol=0, atol=INT8_LOGIT_BOUND) if mode == "paged_int8"
             else LOGIT_TOL)
    cur = np.zeros((2, 1), np.int32)
    jrow, trow = np.asarray(jl), tl
    for _ in range(4):
        np.testing.assert_allclose(trow.numpy(), jrow, **bound)
        cur[1, 0] = int(np.argmax(jrow))
        jl, jstate = _jdecode()(jp, jnp.asarray(cur), jstate)
        tl, tstate = T.decode_step(tp, torch.from_numpy(cur), tstate, cfg,
                                   POL)
        jrow, trow = np.asarray(jl)[1], tl[1]
    np.testing.assert_allclose(trow.numpy(), jrow, **bound)


def _trace(cfg, seed=5, n=6, hi=21):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(3, hi)))
             .astype(np.int32), int(rng.integers(2, 9))) for _ in range(n)]


def _serve(mod, sched, trace):
    for i, (prompt, new) in enumerate(trace):
        sched.submit(mod.Request(rid=i, prompt=prompt, max_new_tokens=new))
    return {r.rid: r.output.tolist() for r in sched.run()}


@pytest.mark.parametrize("mode", ["paged", "paged_int8"])
def test_continuous_scheduler_matches_the_reference(mode):
    """Per-request tokens of ``ContinuousScheduler`` (text only) identical
    to the reference scheduler's on one seeded trace of 3-20 prompt
    tokens and 2-8 new; the pool (11 pages for 2 slots of up to 8) forces
    preemptions, which both take at the same steps; no page leaked.  On
    f32 pages every request's tokens are also the reference's
    ``greedy_generate`` of its prompt."""
    jcfg, cfg, jp, tp = model()
    kw = dict(batch=2, max_len=MAX_LEN, prefill_len=24, cache_mode=mode,
              page_size=4, num_pages=11)
    jsched = JS.ContinuousScheduler(jp, jcfg, JPOL, cache_dtype=jnp.float32,
                                    **kw)
    tsched = S.ContinuousScheduler(tp, cfg, POL, cache_dtype=torch.float32,
                                   device="cpu", **kw)
    trace = _trace(cfg)
    got = _serve(S, tsched, trace)
    assert got == _serve(JS, jsched, trace)
    assert tsched.stats.preemptions == jsched.stats.preemptions > 0
    assert tsched.stats.nonfinite_logits == 0
    assert tsched.allocator.in_use == 0
    if mode == "paged":
        for i, (prompt, new) in enumerate(trace):
            want = JSS.greedy_generate(jp, jnp.asarray(prompt)[None], jcfg,
                                       JPOL, max_new=new, max_len=MAX_LEN)
            assert got[i] == np.asarray(want)[0].tolist()


def test_cohort_scheduler_matches_the_reference():
    """Cohorts of 2 left-padded prompts (bf16 cache on both sides, as the
    reference's default), text only: outputs per rid and the counters
    equal the reference's."""
    jcfg, cfg, jp, tp = model()
    trace = _trace(cfg, seed=6, n=5, hi=25)
    jsched = JS.CohortScheduler(jp, jcfg, JPOL, batch=2, max_len=40)
    tsched = S.CohortScheduler(tp, cfg, POL, batch=2, max_len=40,
                               device="cpu")
    assert _serve(S, tsched, trace) == _serve(JS, jsched, trace)
    for name in ("cohorts", "useful_tokens", "wasted_slots", "decode_steps"):
        assert getattr(tsched.stats, name) == getattr(jsched.stats, name)


def test_prefix_cache_refused_with_the_reference_reason():
    """``prefix_cache=True`` raises ``ValueError`` in both packages, with
    the reference's message (``repro/serve/scheduler.py:495-499``): vision
    embeddings break the token-hash index."""
    jcfg, cfg, jp, tp = model()
    kw = dict(batch=2, max_len=MAX_LEN, cache_mode="paged", page_size=4,
              prefix_cache=True)
    with pytest.raises(ValueError) as want:
        JS.ContinuousScheduler(jp, jcfg, JPOL, **kw)
    with pytest.raises(ValueError) as got:
        S.ContinuousScheduler(tp, cfg, POL, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    assert "vision embeds" in str(got.value) and ARCH in str(got.value)


@functools.lru_cache(maxsize=None)
def _jprefill():
    jcfg = model()[0]
    return jax.jit(lambda p, t, v, st: JT.prefill(p, t, jcfg, JPOL, state=st,
                                                  vision_embeds=v))


def test_raw_prefill_with_vision_matches_the_reference():
    """The raw mode's prefill: 2 prompts of 16 tokens, their first 8
    positions vision embeddings, into a contiguous f32 state: the
    last-token logits within LOGIT_TOL of the reference's
    ``prefill(vision_embeds=)``, and both move (above 1e-3) without the
    embeddings; the next positions equal."""
    jcfg, cfg, jp, tp = model()
    toks, vis = tokens(cfg, (2, 16), 22), vision(cfg, 2, 23)
    jstate = JT.init_decode_state(jcfg, 2, 20, jnp.float32)
    jl, jstate = _jprefill()(jp, jnp.asarray(toks), jnp.asarray(vis),
                             jstate)
    tl = {}
    for given in (True, False):
        state = T.init_decode_state(cfg, 2, 20, torch.float32, device="cpu")
        tl[given], state = T.prefill(
            tp, torch.from_numpy(toks), cfg, POL, state=state,
            vision_embeds=torch.from_numpy(vis) if given else None)
    np.testing.assert_allclose(tl[True].numpy(), np.asarray(jl),
                               **LOGIT_TOL)
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist()
    assert rel_l2(tl[False].numpy(), tl[True].numpy()) > 1e-3


def test_greedy_generate_with_vision_matches_the_reference():
    """Greedy tokens of a (2, 16) prompt with vision embeddings, 6 new,
    equal the reference's ``greedy_generate(vision_embeds=)``."""
    jcfg, cfg, jp, tp = model()
    toks, vis = tokens(cfg, (2, 16), 24), vision(cfg, 2, 25)
    want = JSS.greedy_generate(jp, jnp.asarray(toks), jcfg, JPOL, max_new=6,
                               max_len=MAX_LEN,
                               vision_embeds=jnp.asarray(vis))
    got = SS.greedy_generate(tp, torch.from_numpy(toks), cfg, POL,
                             max_new=6, max_len=MAX_LEN,
                             vision_embeds=torch.from_numpy(vis))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("argv", [
    ["--mode", "raw", "--prompt-len", "12", "--new-tokens", "4"],
    ["--mode", "continuous", "--cache-mode", "paged_int8", "--requests",
     "5"],
    ["--mode", "cohort", "--requests", "5"]])
def test_serve_cli_serves_qwen2vl(argv):
    """The serve CLI on the CPU: the raw mode with its vision embeddings
    (12-token prompts, 8 of them vision), continuous (text only) on int8
    pages and cohort, each to its end."""
    out = serve_cli.main(["--arch", ARCH, "--device", "cpu", *argv])
    if argv[1] == "raw":
        assert out.shape == (4, 4)
    else:
        assert len(out.stats.__dict__) and out.stats.nonfinite_logits == 0


def test_serve_cli_refusals():
    """The raw mode refuses a prompt shorter than the vision tokens, and
    the prefix cache is refused (``ValueError``)."""
    with pytest.raises(SystemExit, match="vision"):
        serve_cli.main(["--arch", ARCH, "--device", "cpu", "--mode", "raw",
                        "--prompt-len", "7"])
    with pytest.raises(ValueError, match="prefix_shareable"):
        serve_cli.main(["--arch", ARCH, "--device", "cpu", "--mode",
                        "continuous", "--cache-mode", "paged",
                        "--prefix-cache"])
    drawn = serve_cli.vision_embeds(model()[1], np.random.default_rng(0), 3)
    assert drawn.shape == (3, 8, 256) and drawn.dtype == np.float32
