"""Serving the dense decoder variants (gemma2-27b, qwen1.5-32b,
deepseek-coder-33b) through the port's entry points against the JAX
package at f32, on the perturbed weights of ``test_torch_decoders``: the
slot prefill, ``ContinuousScheduler`` (gemma2 in contiguous mode, its
rings wrapping; qwen and the coder paged), ``CohortScheduler`` and greedy
generation, gemma2's refusals, and the serve CLI's three modes on each."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serve import scheduler as JS
from repro.serve import serve_step as JSS
from repro_torch.core.amp import make_policy
from repro_torch.models import transformer as T
from repro_torch.serve import scheduler as S
from repro_torch.serve import serve_step as SS
from test_torch_decoders import JPOL, LOGIT_TOL, _jdecode, _model
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

POL = make_policy("f32")
# int8 pages: the same values quantised with the same rounding on both
# sides (tests/test_torch_scheduler.py)
INT8_LOGIT_BOUND = 1e-2


@pytest.mark.parametrize("arch,mode", [
    ("gemma2-27b", "contiguous"), ("qwen1.5-32b", "paged"),
    ("qwen1.5-32b", "paged_int8"), ("deepseek-coder-33b", "paged"),
    ("deepseek-coder-33b", "contiguous")])
def test_prefill_into_slot_matches_jax(arch, mode):
    """One 14-token request prefilled into slot 1 of a live 2-slot state
    (bucket 16 = gemma2's window), then 4 decode steps, past gemma2's
    16-row ring; logits within LOGIT_TOL (INT8_LOGIT_BOUND for int8
    pages), the neighbour slot untouched."""
    jcfg, cfg, jp, tp = _model(arch)
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
    toks[0, :length] = np.random.default_rng(11).integers(
        0, cfg.vocab_size, length)
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
        jl, jstate = _jdecode(arch)(jp, jnp.asarray(cur), jstate)
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


@pytest.mark.parametrize("arch,mode", [
    ("gemma2-27b", "contiguous"), ("qwen1.5-32b", "paged"),
    ("deepseek-coder-33b", "paged"), ("deepseek-coder-33b", "paged_int8")])
def test_continuous_scheduler_matches_jax(arch, mode):
    """Per-request tokens of ContinuousScheduler identical to the
    reference scheduler's on one seeded trace of 3-20 prompt tokens and
    2-8 new: gemma2 with bucket 16 (its window; prompts keep their last 16
    tokens) decodes past its rings; the paged pool (11 pages for 2 slots
    of up to 8) forces preemptions, which both take at the same steps."""
    jcfg, cfg, jp, tp = _model(arch)
    kw = dict(batch=2, max_len=32, prefill_len=16 if cfg.sliding_window
              else 24, cache_mode=mode, page_size=4,
              num_pages=None if mode == "contiguous" else 11)
    jsched = JS.ContinuousScheduler(jp, jcfg, JPOL, cache_dtype=jnp.float32,
                                    **kw)
    tsched = S.ContinuousScheduler(tp, cfg, POL, cache_dtype=torch.float32,
                                   device="cpu", **kw)
    trace = _trace(cfg)
    assert _serve(S, tsched, trace) == _serve(JS, jsched, trace)
    assert tsched.stats.preemptions == jsched.stats.preemptions
    assert tsched.stats.useful_tokens == jsched.stats.useful_tokens
    assert tsched.stats.nonfinite_logits == 0
    if mode != "contiguous":
        assert tsched.stats.preemptions > 0
        assert tsched.allocator.in_use == 0


@pytest.mark.parametrize("arch", ["gemma2-27b", "deepseek-coder-33b"])
def test_cohort_scheduler_matches_jax(arch):
    """Cohorts of 2 left-padded prompts of 3-24 tokens (bf16 cache on
    both sides, as the reference's default): gemma2's cohort prefills
    wider than its 16-row rings roll them; outputs per rid and the
    counters equal the reference's."""
    jcfg, cfg, jp, tp = _model(arch)
    trace = _trace(cfg, seed=6, n=5, hi=25)
    jsched = JS.CohortScheduler(jp, jcfg, JPOL, batch=2, max_len=40)
    tsched = S.CohortScheduler(tp, cfg, POL, batch=2, max_len=40,
                               device="cpu")
    assert _serve(S, tsched, trace) == _serve(JS, jsched, trace)
    for name in ("cohorts", "useful_tokens", "wasted_slots", "decode_steps"):
        assert getattr(tsched.stats, name) == getattr(jsched.stats, name)


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen1.5-32b",
                                  "deepseek-coder-33b"])
def test_greedy_generate_matches_jax(arch):
    """Greedy tokens of a (2, 20) prompt, 6 new, equal the reference's
    (gemma2's 16-row rings roll at the prefill)."""
    jcfg, cfg, jp, tp = _model(arch)
    prompt = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want = JSS.greedy_generate(jp, jnp.asarray(prompt), jcfg, JPOL,
                               max_new=6, max_len=32)
    got = SS.greedy_generate(tp, torch.from_numpy(prompt), cfg, POL,
                             max_new=6, max_len=32)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_gemma2_refusals_match_the_reference():
    """Paged and int8-paged caches and the prefix cache are refused with
    ``ValueError`` by both packages (scheduler.py:485-500); a slot prefill
    wider than the 16-row ring is refused too (the reference asserts at
    the first admission, the port at construction and in the slot
    prefill), and a 16-token bucket serves."""
    jcfg, cfg, jp, tp = _model("gemma2-27b")
    kw = dict(batch=2, max_len=32, prefill_len=16)
    for extra, match in ((dict(cache_mode="paged"), "pageable"),
                         (dict(cache_mode="paged_int8"), "pageable"),
                         (dict(cache_mode="paged", prefix_cache=True),
                          "pageable"),
                         (dict(prefix_cache=True),
                          "prefix_cache requires a paged")):
        with pytest.raises(ValueError, match=match):
            JS.ContinuousScheduler(jp, jcfg, JPOL, **kw, **extra)
        with pytest.raises(ValueError, match=match):
            S.ContinuousScheduler(tp, cfg, POL, device="cpu", **kw, **extra)
    with pytest.raises(ValueError, match="sliding window"):
        S.ContinuousScheduler(tp, cfg, POL, batch=2, max_len=32,
                              prefill_len=24, device="cpu")
    toks = np.zeros((1, 24), np.int32)
    jstate = JT.init_decode_state(jcfg, 2, 32, jnp.float32)
    with pytest.raises(AssertionError, match="windowed"):
        JSS.prefill_into_slot(jp, jnp.asarray(toks), 5, jstate, 0, jcfg,
                              JPOL)
    tstate = T.init_decode_state(cfg, 2, 32, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="ring of 16 rows"):
        SS.prefill_into_slot(tp, torch.from_numpy(toks), 5, tstate, 0, cfg,
                             POL)
    S.ContinuousScheduler(tp, cfg, POL, device="cpu", **kw)


# mode -> lines the CLI must log
CLI_LINES = {"raw": ["prefill: 4 x 16 tokens", "generated ids"],
             "cohort": ["cohort: 3 requests done", "cohorts 1"],
             "continuous": ["continuous: 3 requests done",
                            "KV cache bytes"]}


@pytest.mark.parametrize("mode", list(CLI_LINES))
@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen1.5-32b",
                                  "deepseek-coder-33b"])
def test_serve_cli_runs_on_cpu(arch, mode, caplog):
    """``launch/serve.py --arch`` takes the three variants in the raw,
    cohort and continuous modes (contiguous cache for gemma2, int8 pages
    for the others) at the smoke size: 16-token prompts, gemma2's window."""
    from repro_torch.launch import serve
    cache = "contiguous" if arch == "gemma2-27b" else "paged_int8"
    args = ["--device", "cpu", "--arch", arch, "--mode", mode,
            "--cache-mode", cache, "--requests", "3", "--prompt-len", "16",
            "--new-tokens", "4"]
    with caplog.at_level("INFO", logger="repro_torch.serve"):
        out = serve.main(args)
    for line in CLI_LINES[mode]:
        assert line in caplog.text, line
    assert f"serving {arch} (reduced)" in caplog.text
    if mode == "raw":
        assert out.shape == (4, 4)
    else:
        assert out.stats.nonfinite_logits == 0 and out.stats.useful_tokens
