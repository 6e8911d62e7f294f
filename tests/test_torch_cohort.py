"""The port's ``CohortScheduler`` against the JAX package at f32 on the
same weights (outputs and every ServeStats counter), and twins of the
reference's cohort tests (``tests/test_serve.py``) on the port."""
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
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.serve import scheduler as S
from test_torch_prefix import COUNTERS
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

JCFG = jsmoke(jget_config("deepseek-7b"), n_blocks=2)
CFG = smoke_variant(get_config("deepseek-7b"), n_blocks=2)
JPOL, POL = jmake_policy("f32"), make_policy("f32")


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(lambda key: JT.init_model(key, JCFG)[0])(
        jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return jp, bridge.params_from_jax(np_params, CFG, device="cpu")


def _trace(seed, n, lo, hi, new_hi):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab_size, size=int(rng.integers(lo, hi)),
                          dtype=np.int32), int(rng.integers(2, new_hi)))
            for _ in range(n)]


def _serve(mod, sched, trace):
    for i, (prompt, new) in enumerate(trace):
        sched.submit(mod.Request(rid=i, prompt=prompt, max_new_tokens=new))
    return {r.rid: r.output.tolist() for r in sched.run()}


def test_cohort_scheduler_matches_jax(weights):
    """10 requests of 4-11 prompt tokens in cohorts of 4 (the last padded
    with two dummy slots), left-padded, bf16 cache on both sides: outputs
    per rid and every counter equal to the reference's."""
    jp, tp = weights
    trace = _trace(0, 10, 4, 12, 8)
    jsched = JS.CohortScheduler(jp, JCFG, JPOL, batch=4, max_len=64)
    tsched = S.CohortScheduler(tp, CFG, POL, batch=4, max_len=64,
                               device="cpu")
    want, got = _serve(JS, jsched, trace), _serve(S, tsched, trace)
    assert got == want
    for name in COUNTERS:
        assert getattr(tsched.stats, name) == getattr(jsched.stats, name), \
            name
    assert tsched.stats.cohorts == 3 and tsched.stats.nonfinite_logits == 0
    assert tsched.stats.slot_utilisation == jsched.stats.slot_utilisation


def test_utilisation_matches_jax(weights):
    """A mixed-length trace (12 requests, 2-15 new tokens, batch 4)
    through both schedulers of both packages: each port scheduler's
    counters and slot utilisation equal its reference twin's.  (The
    reference's own claim that continuous beats cohort is its test's, and
    is not asserted here.)"""
    jp, tp = weights
    trace = _trace(3, 12, 4, 17, 16)
    pairs = [
        (JS.CohortScheduler(jp, JCFG, JPOL, batch=4, max_len=48),
         S.CohortScheduler(tp, CFG, POL, batch=4, max_len=48,
                           device="cpu")),
        (JS.ContinuousScheduler(jp, JCFG, JPOL, batch=4, max_len=48,
                                prefill_len=16, cache_dtype=jnp.float32),
         S.ContinuousScheduler(tp, CFG, POL, batch=4, max_len=48,
                               prefill_len=16, cache_dtype=torch.float32,
                               device="cpu"))]
    for jsched, tsched in pairs:
        assert _serve(S, tsched, trace) == _serve(JS, jsched, trace)
        for name in COUNTERS:
            assert getattr(tsched.stats, name) == \
                getattr(jsched.stats, name), name
        assert tsched.stats.slot_utilisation == \
            jsched.stats.slot_utilisation
        assert 0 < tsched.stats.slot_utilisation <= 1.0


# --- twins of tests/test_serve.py on the port ------------------------------

def test_cohort_scheduler_serves_queue(weights):
    _, tp = weights
    sched = S.CohortScheduler(tp, CFG, POL, batch=4, max_len=64,
                              device="cpu")
    rng = np.random.default_rng(0)
    for i in range(10):  # 10 requests -> 3 cohorts of <= 4
        sched.submit(S.Request(
            rid=i, prompt=rng.integers(0, CFG.vocab_size,
                                       size=rng.integers(4, 12),
                                       dtype=np.int32),
            max_new_tokens=int(rng.integers(2, 8))))
    done = sched.run()
    assert len(done) == 10
    for r in done:
        assert r.output is not None
        assert 1 <= len(r.output) <= r.max_new_tokens
        assert r.latency_s > 0
        assert 0 < r.first_token_s <= r.latency_s
    assert sched.stats.cohorts == 3
    assert 0 < sched.stats.slot_utilisation <= 1.0
    assert sched.stats.tokens_per_s > 0


def test_cohort_stats_zero_budget_not_credited(weights):
    """Dummy slots and zero-budget requests earn no useful tokens and an
    empty output; latencies are each request's own."""
    _, tp = weights
    sched = S.CohortScheduler(tp, CFG, POL, batch=4, max_len=64,
                              device="cpu")
    prompt = np.arange(4, dtype=np.int32)
    for rid, new in ((0, 0), (1, 2), (2, 6)):
        sched.submit(S.Request(rid=rid, prompt=prompt, max_new_tokens=new))
    by_rid = {r.rid: r for r in sched.run()}
    assert len(by_rid[0].output) == 0
    assert len(by_rid[1].output) == 2
    assert len(by_rid[2].output) == 6
    assert sched.stats.useful_tokens == 8
    assert by_rid[1].latency_s < by_rid[2].latency_s


def test_cohort_refuses_a_prompt_past_max_len(weights):
    _, tp = weights
    sched = S.CohortScheduler(tp, CFG, POL, batch=2, max_len=16,
                              device="cpu")
    sched.submit(S.Request(rid=0, prompt=np.arange(12, dtype=np.int32),
                           max_new_tokens=8))
    with pytest.raises(ValueError, match="max_len"):
        sched.run()
