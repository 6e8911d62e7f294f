"""The port's serving slice against the JAX package at f32: the weight
bridge, prefill + decode logits of the transformer, greedy generation and
the serve CLI (slot prefill and the scheduler are in
test_torch_scheduler.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.amp import make_policy as jmake_policy
from repro.models import transformer as JT
from repro.serve import serve_step as JSS
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import transformer as T
from repro_torch.serve import serve_step as SS

JCFG = jsmoke(jget_config("deepseek-7b"), n_blocks=2)
CFG = smoke_variant(get_config("deepseek-7b"), n_blocks=2)
JPOL, POL = jmake_policy("f32"), make_policy("f32")
# f32 logits of a 2-layer model: the two frameworks differ only in
# summation order (measured ~1e-6); 1e-4 leaves room for other BLAS builds
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    jp, _ = JT.init_model(jax.random.PRNGKey(0), JCFG)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return jp, bridge.params_from_jax(np_params, CFG, device="cpu")


def test_params_from_jax_round_trips_bit_exactly(weights):
    jp, tp = weights
    assert len(tp["blocks"]) == CFG.n_layers
    assert tp["blocks"][0]["mixer"]["wq"].shape == (
        CFG.d_model, CFG.n_heads, CFG.head_dim)
    back = bridge.params_to_numpy(tp, CFG)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jp))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        assert flat_b[path].dtype == leaf.dtype
        assert np.array_equal(flat_b[path], leaf), path


def test_init_model_is_seeded():
    a = T.init_model(CFG, seed=3, device="cpu")
    b = T.init_model(CFG, seed=3, device="cpu")
    c = T.init_model(CFG, seed=4, device="cpu")
    assert torch.equal(a["lm_head"], b["lm_head"])
    assert not torch.equal(a["lm_head"], c["lm_head"])
    w = a["blocks"][0]["mixer"]["wq"]
    assert float(w.abs().max()) <= 0.04 and 0.01 < float(w.std()) < 0.02


def test_apply_lm_matches_jax(weights):
    """Full forward: logits at every position of a (2, 40) batch."""
    jp, tp = weights
    toks = np.random.default_rng(2).integers(
        0, CFG.vocab_size, (2, 40)).astype(np.int32)
    want, _ = JT.apply_lm(jp, jnp.asarray(toks), JCFG, JPOL)
    got = T.apply_lm(tp, torch.from_numpy(toks), CFG, POL)
    assert got.shape == (2, 40, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("s", [12, 1024])
def test_prefill_and_decode_match_jax(weights, s):
    """Prefill (S=1024 takes the flash branch) + 8 decode steps fed the same
    tokens; logits within LOGIT_TOL and identical greedy tokens."""
    jp, tp = weights
    rng = np.random.default_rng(s)
    prompt = rng.integers(0, CFG.vocab_size, (2, s)).astype(np.int32)
    max_len = s + 9
    jstate = JT.init_decode_state(JCFG, 2, max_len, jnp.float32)
    tstate = T.init_decode_state(CFG, 2, max_len, torch.float32,
                                 device="cpu")
    jl, jstate = JT.prefill(jp, jnp.asarray(prompt), JCFG, JPOL,
                            state=jstate)
    tl, tstate = T.prefill(tp, torch.from_numpy(prompt), CFG, POL,
                           state=tstate)
    for _ in range(8):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.array(jnp.argmax(jl, -1))[:, None]
        assert np.array_equal(tl.argmax(-1).numpy(), tok[:, 0])
        jl, jstate = JT.decode_step(jp, jnp.asarray(tok), jstate, JCFG, JPOL)
        tl, tstate = T.decode_step(tp, torch.from_numpy(tok), tstate, CFG,
                                   POL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tstate["pos"].tolist() == np.asarray(jstate["pos"]).tolist()


def test_greedy_generate_matches_jax(weights):
    jp, tp = weights
    prompt = np.random.default_rng(9).integers(
        0, CFG.vocab_size, (2, 7)).astype(np.int32)
    want = JSS.greedy_generate(jp, jnp.asarray(prompt), JCFG, JPOL,
                               max_new=5, max_len=16)
    got = SS.greedy_generate(tp, torch.from_numpy(prompt), CFG, POL,
                             max_new=5, max_len=16)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["raw", "continuous"])
def test_serve_cli_runs_on_cpu(mode):
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--mode", mode, "--cache-mode",
                      "paged_int8", "--requests", "3", "--prompt-len", "16",
                      "--new-tokens", "4"])
    if mode == "raw":
        assert out.shape == (4, 4)
    else:
        assert out.allocator.in_use == 0
        assert out.stats.prefills == 3 and out.stats.nonfinite_logits == 0
