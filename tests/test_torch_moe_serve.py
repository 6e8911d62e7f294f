"""The MoE decoders granite-moe-3b-a800m and qwen3-moe-30b-a3b served
through the port's entry points against the JAX package (smoke sizes: d
256, 4 experts top-2, one block unless said): the configs, the full
forward with its aux loss, prefill and decode (twin of
tests/test_serve.py:17), the slot prefill in every cache mode under the
dense and the capacity path, ``ContinuousScheduler`` with paged and int8
pages, ``CohortScheduler`` and greedy generation.
(``tests/test_torch_moe_forward.py``: ``lm_train_loss`` with
``router_aux``, qwen3's query/key norms on and off, the bf16 routing
agreement and the CLIs, on the same weights.)

Weights are the reference's init with every norm scale (the query/key
norms' too) at 1 + 0.1 N(0, 1) and the router's weights times 5, so that
neither the norms nor the routing can agree by being ones or near-uniform;
they cross over through ``bridge.params_from_jax``.  f32 logits within
LOGIT_TOL (summation order only), int8 pages INT8_LOGIT_BOUND, the port's
prefill and decode against its own forward at the reference test's 2e-3,
and the bf16 forward within chip_smoke.py's bf16 logits bound
(``BF16_LOGIT_REL_L2``)."""
import dataclasses
import functools

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

ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")
JPOL, POL = jmake_policy("f32"), make_policy("f32")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
INT8_LOGIT_BOUND = 1e-2
# the port's prefill/decode against its own forward (tests/test_serve.py:17)
FORWARD_TOL = dict(rtol=2e-3, atol=2e-3)
# chip_smoke.py's LOGIT_REL_L2_BOUND for bf16
BF16_LOGIT_REL_L2 = 5e-2
ROUTER_GAIN = 5.0


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if name.endswith(("['scale']", "['q_norm']", "['k_norm']")):
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(
                np.float32)
        if name.endswith("['router']"):
            return (ROUTER_GAIN * x).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def _model(arch, n_blocks=1, qk_norm=None):
    """(reference config, port config, JAX params, port params) of the
    smoke variant, the same perturbed weights on both sides; ``qk_norm``
    overrides the config's."""
    jcfg = jsmoke(jget_config(arch), n_blocks=n_blocks)
    cfg = smoke_variant(get_config(arch), n_blocks=n_blocks)
    if qk_norm is not None:
        jcfg = dataclasses.replace(jcfg, qk_norm=qk_norm)
        cfg = dataclasses.replace(cfg, qk_norm=qk_norm)
    jp = jax.jit(lambda key: JT.init_model(key, jcfg)[0])(
        jax.random.PRNGKey(0))
    np_params = _perturbed(jp, seed=1)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, np_params),
            bridge.params_from_jax(np_params, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jdecode(arch, moe_impl="dense", n_blocks=1):
    jcfg = _model(arch, n_blocks)[0]
    return jax.jit(functools.partial(JT.decode_step, cfg=jcfg, policy=JPOL,
                                     moe_impl=moe_impl))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    """Every field of the full config and of the smoke variant (4
    experts, top-2, expert d_ff 2 d), the parameter counts (all and
    active) and the serving capabilities equal the reference's; the
    parameter leaves of the smoke model carry the reference's shapes both
    ways through the bridge."""
    for full in (True, False):
        cfg, jcfg = get_config(arch), jget_config(arch)
        if not full:
            cfg, jcfg = smoke_variant(cfg), jsmoke(jcfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for active in (False, True):
            assert cfg.param_count(active) == jcfg.param_count(active)
        assert dataclasses.asdict(cfg.decode_caps) == dataclasses.asdict(
            jcfg.decode_caps)
        assert cfg.has_moe and cfg.decode_caps.pageable
    assert 3.2e9 < get_config("granite-moe-3b-a800m").param_count() < 3.4e9
    assert 29e9 < get_config("qwen3-moe-30b-a3b").param_count() < 32e9
    jcfg, cfg, jp, tp = _model(arch)
    mlp = tp["blocks"][0]["mlp"]
    assert {k: tuple(v.shape) for k, v in mlp.items()} == {
        "router": (256, 4), "wi": (4, 256, 512), "wg": (4, 256, 512),
        "wo": (4, 512, 256)}
    assert ("q_norm" in tp["blocks"][0]["mixer"]) == cfg.qk_norm
    back = bridge.params_to_numpy(tp, cfg)
    same = jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(np.asarray(a), b)), jp, back)
    assert all(jax.tree_util.tree_leaves(same))
    own = T.init_model(cfg, seed=0, device="cpu")
    assert jax.tree_util.tree_map(np.shape, bridge.params_to_numpy(
        own, cfg)) == jax.tree_util.tree_map(np.shape, back)


# ---------------------------------------------------------------------------
# forward, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moe_impl", ["dense", "a2a"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_lm_and_aux_match_jax(arch, moe_impl):
    """Full forward at two blocks of (2, 24) tokens: logits and the aux
    loss summed over the layers equal the reference's, under the oracle
    and the capacity path (capacity 30 of 48 x 2 assignments over 4
    experts: drops happen)."""
    jcfg, cfg, jp, tp = _model(arch, 2)
    toks = _tokens(cfg, (2, 24), 2)
    want, jaux = jax.jit(functools.partial(
        JT.apply_lm, cfg=jcfg, policy=JPOL, moe_impl=moe_impl))(
            jp, jnp.asarray(toks))
    got, aux = T.apply_lm(tp, torch.from_numpy(toks), cfg, POL,
                          moe_impl=moe_impl, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    plain = T.apply_lm(tp, torch.from_numpy(toks), cfg, POL,
                       moe_impl=moe_impl)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("moe_impl", ["dense", None])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_jax_and_forward(arch, moe_impl):
    """tests/test_serve.py:17 on the port: a 28-token prefill and 4
    decode steps fed the true tokens, under ``dense`` and under the
    functions' defaults (prefill "a2a", decode "replicated": the capacity
    path on one device, at T = 56 and T = 2); each step's logits within
    LOGIT_TOL of the reference's and, under ``dense``, within 2e-3 of
    the port's own dense forward."""
    jcfg, cfg, jp, tp = _model(arch)
    b, s = 2, 32
    toks = _tokens(cfg, (b, s), 7)
    kw = {} if moe_impl is None else dict(moe_impl=moe_impl)
    full = T.apply_lm(tp, torch.from_numpy(toks), cfg, POL, moe_impl="dense")
    jstate = JT.init_decode_state(jcfg, b, s + 8, jnp.float32)
    tstate = T.init_decode_state(cfg, b, s + 8, torch.float32, device="cpu")
    jl, jstate = jax.jit(functools.partial(
        JT.prefill, cfg=jcfg, policy=JPOL, **kw))(
            jp, jnp.asarray(toks[:, :s - 4]), state=jstate)
    tl, tstate = T.prefill(tp, torch.from_numpy(toks[:, :s - 4]), cfg, POL,
                           state=tstate, **kw)
    jstep = _jdecode(arch, moe_impl or "replicated")
    for t in range(s - 4, s + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        if moe_impl == "dense":
            np.testing.assert_allclose(tl.numpy(), full[:, t - 1].numpy(),
                                       **FORWARD_TOL)
        if t == s:
            break
        tok = toks[:, t:t + 1]
        jl, jstate = jstep(jp, jnp.asarray(tok), jstate)
        tl, tstate = T.decode_step(tp, torch.from_numpy(tok), tstate, cfg,
                                   POL, **kw)
    assert tstate["pos"].tolist() == np.asarray(jstate["pos"]).tolist()


@pytest.mark.parametrize("moe_impl", ["dense", "a2a"])
@pytest.mark.parametrize("arch,mode", [
    ("granite-moe-3b-a800m", "paged"), ("granite-moe-3b-a800m", "paged_int8"),
    ("qwen3-moe-30b-a3b", "paged"), ("qwen3-moe-30b-a3b", "contiguous")])
def test_prefill_into_slot_matches_jax(arch, mode, moe_impl):
    """One 11-token request right-padded to a 16-token bucket, prefilled
    into slot 1 of a live 2-slot state, then 4 decode steps; under
    ``a2a`` the bucket's 5 pad tokens route and take capacity (C 10 of
    32 assignments) as in the reference's one-row prefill.  Logits within
    LOGIT_TOL (INT8_LOGIT_BOUND for int8 pages), the neighbour slot
    untouched."""
    jcfg, cfg, jp, tp = _model(arch)
    bucket, max_len, ps, length = 16, 24, 4, 11
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
    toks[0, :length] = _tokens(cfg, (length,), 11)
    jl, jstate = jax.jit(functools.partial(
        JSS.prefill_into_slot, cfg=jcfg, policy=JPOL, moe_impl=moe_impl),
        static_argnums=4)(jp, jnp.asarray(toks), length, jstate, 1)
    tl, tstate = SS.prefill_into_slot(tp, torch.from_numpy(toks), length,
                                      tstate, 1, cfg, POL, moe_impl=moe_impl)
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
        jl, jstate = _jdecode(arch, moe_impl)(jp, jnp.asarray(cur), jstate)
        tl, tstate = T.decode_step(tp, torch.from_numpy(cur), tstate, cfg,
                                   POL, moe_impl=moe_impl)
        jrow, trow = np.asarray(jl)[1], tl[1]
    np.testing.assert_allclose(trow.numpy(), jrow, **bound)


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

def _trace(cfg, seed=5, n=6, hi=21):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(3, hi)))
             .astype(np.int32), int(rng.integers(2, 9))) for _ in range(n)]


def _serve(mod, sched, trace):
    for i, (prompt, new) in enumerate(trace):
        sched.submit(mod.Request(rid=i, prompt=prompt, max_new_tokens=new))
    return {r.rid: r.output.tolist() for r in sched.run()}


@pytest.mark.parametrize("arch,mode", [
    ("granite-moe-3b-a800m", "paged"), ("granite-moe-3b-a800m", "paged_int8"),
    ("qwen3-moe-30b-a3b", "paged"), ("qwen3-moe-30b-a3b", "paged_int8")])
def test_continuous_scheduler_matches_jax(arch, mode):
    """Per-request tokens of ContinuousScheduler (``moe_impl`` "dense", the
    default of both) identical to the reference scheduler's on one seeded
    trace of 3-20 prompt tokens and 2-8 new; the 11-page pool for 2 slots
    forces preemptions, which both take at the same steps."""
    jcfg, cfg, jp, tp = _model(arch)
    kw = dict(batch=2, max_len=32, prefill_len=24, cache_mode=mode,
              page_size=4, num_pages=11)
    jsched = JS.ContinuousScheduler(jp, jcfg, JPOL, cache_dtype=jnp.float32,
                                    **kw)
    tsched = S.ContinuousScheduler(tp, cfg, POL, cache_dtype=torch.float32,
                                   device="cpu", **kw)
    assert tsched.moe_impl == tsched.adapter.moe_impl == "dense"
    trace = _trace(cfg)
    assert _serve(S, tsched, trace) == _serve(JS, jsched, trace)
    assert tsched.stats.preemptions == jsched.stats.preemptions > 0
    assert tsched.stats.useful_tokens == jsched.stats.useful_tokens
    assert tsched.stats.nonfinite_logits == 0
    assert tsched.allocator.in_use == 0


def test_cohort_scheduler_and_greedy_match_jax():
    """granite's cohorts of 2 left-padded prompts (bf16 cache on both
    sides) and greedy generation of a (2, 20) prompt, 6 new, equal the
    reference's, token for token."""
    jcfg, cfg, jp, tp = _model("granite-moe-3b-a800m")
    trace = _trace(cfg, seed=6, n=5, hi=25)
    jsched = JS.CohortScheduler(jp, jcfg, JPOL, batch=2, max_len=40)
    tsched = S.CohortScheduler(tp, cfg, POL, batch=2, max_len=40,
                               device="cpu")
    assert _serve(S, tsched, trace) == _serve(JS, jsched, trace)
    prompt = _tokens(cfg, (2, 20), 12)
    want = JSS.greedy_generate(jp, jnp.asarray(prompt), jcfg, JPOL,
                               max_new=6, max_len=32)
    got = SS.greedy_generate(tp, torch.from_numpy(prompt), cfg, POL,
                             max_new=6, max_len=32)
    assert np.array_equal(got.numpy(), np.asarray(want))
