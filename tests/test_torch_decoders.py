"""The dense decoder variants of the port against the JAX package at f32
(smoke sizes): gemma2-27b (sliding-window rings, attention and final
softcaps, post-block norms, GeGLU, tied and scaled embeddings),
qwen1.5-32b (QKV biases) and deepseek-coder-33b (grouped-query attention)
-- the configs and parameter counts, the layers, the full forward, prefill
and decode, decode past the window and the roll of a prefill wider than the
ring.  Weights are the reference's init, with the QKV biases and every norm
scale moved away from zeros and ones, carried across by
``bridge.params_from_jax``."""
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ("gemma2-27b", "qwen1.5-32b", "deepseek-coder-33b")
JPOL, POL = jmake_policy("f32"), make_policy("f32")
# f32 logits of a few layers: the frameworks differ only in summation order
# (tests/test_torch_serve.py)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# one layer's output at f32 (tests/test_torch_layers.py)
TOL = dict(rtol=1e-5, atol=1e-5)


def _perturbed(tree, seed):
    """A numpy copy of a JAX parameter tree with the QKV biases drawn
    (std 0.5) and every norm scale 1 + 0.1 N(0, 1), so that neither the
    bias path nor the norms' scales can agree by being zeros or ones."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if name.endswith(("['bq']", "['bk']", "['bv']")):
            return (0.5 * rng.standard_normal(x.shape)).astype(np.float32)
        if "norm" in name and name.endswith("['scale']"):
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(
                np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def _model(arch, n_blocks=1):
    """(reference config, port config, JAX params, port params) of the
    smoke variant, the same perturbed weights on both sides."""
    jcfg = jsmoke(jget_config(arch), n_blocks=n_blocks)
    cfg = smoke_variant(get_config(arch), n_blocks=n_blocks)
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    np_params = _perturbed(jp, seed=1)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, np_params),
            bridge.params_from_jax(np_params, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jdecode(arch, n_blocks=1):
    """The reference's decode step, jitted once (eager it retraces its
    scan at every step)."""
    jcfg = _model(arch, n_blocks)[0]
    return jax.jit(functools.partial(JT.decode_step, cfg=jcfg, policy=JPOL))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs (twins of tests/test_system.py:18, :47 and
# tests/test_slot_state.py:41)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    """Every field of the full config and of the smoke variant, the
    parameter count and the serving capabilities equal the reference's;
    the assigned widths as tests/test_system.py:18 lists them."""
    for full in (True, False):
        cfg, jcfg = get_config(arch), jget_config(arch)
        if not full:
            cfg, jcfg = smoke_variant(cfg), jsmoke(jcfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert dataclasses.asdict(cfg.decode_caps) == dataclasses.asdict(
            jcfg.decode_caps)
    expected = {"qwen1.5-32b": (64, 5120, 27392, 152064),
                "deepseek-coder-33b": (62, 7168, 19200, 32256),
                "gemma2-27b": (46, 4608, 36864, 256000)}[arch]
    cfg = get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == expected
    assert cfg.source and arch in PORT_ARCHS


def test_param_counts_plausible():
    """Full-size analytic counts in the reference's ranges
    (tests/test_system.py:47)."""
    assert 28e9 < get_config("qwen1.5-32b").param_count() < 36e9
    assert 28e9 < get_config("deepseek-coder-33b").param_count() < 38e9
    assert 22e9 < get_config("gemma2-27b").param_count() < 32e9
    assert 5.5e9 < get_config("deepseek-7b").param_count() < 8e9
    assert 1.2e9 < get_config("rwkv6-1.6b").param_count() < 2.2e9


def test_capability_matrix():
    """The rows of tests/test_slot_state.py:41 for the decoders the port
    serves: gemma2 is windowed, neither pageable nor prefix-shareable."""
    rows = {
        # arch            page   share  exact  const  window cross
        "deepseek-7b":   (True, True, False, False, False, False),
        "qwen1.5-32b":   (True, True, False, False, False, False),
        "deepseek-coder-33b": (True, True, False, False, False, False),
        "rwkv6-1.6b":    (False, False, True, True, False, False),
        "gemma2-27b":    (False, False, False, False, True, False),
    }
    for arch, want in rows.items():
        c = get_config(arch).decode_caps
        got = (c.pageable, c.prefix_shareable, c.needs_exact_prefill,
               c.constant_state, c.windowed, c.cross_cache)
        assert got == want, (arch, got, want)
        assert dataclasses.asdict(c) == dataclasses.asdict(
            jget_config(arch).decode_caps)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 16, 0), (True, 5, 7), (False, 16, 0), (True, 0, 3)])
def test_naive_attention_window(causal, window, q_offset):
    """The mask ``k > q + q_offset - window`` at absolute positions, GQA 7
    query heads a KV head, softcap 50 (layers.py:201-202)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 9, 7, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 20, 1, 32)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=50.0, q_offset=q_offset)
    want = JL.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
    got = L.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch,mixer,s", [
    ("gemma2-27b", "attn_local", 40), ("gemma2-27b", "attn_global", 40),
    ("qwen1.5-32b", "attn", 12), ("deepseek-coder-33b", "attn", 12)])
def test_attention_no_cache(arch, mixer, s):
    """One attention layer on (2, S): the local window and the softcap
    (gemma2), the QKV biases added before RoPE (qwen), 4 query heads over
    one KV head (the coder's smoke); the prompt's K/V returned for the
    cache, biases included."""
    jcfg, cfg, jp, tp = _model(arch)
    i = [m for m, _ in cfg.layer_kinds()].index(mixer)
    jparams = jax.tree_util.tree_map(lambda a: a[i // len(
        jcfg.block_pattern)], jp["blocks"][i % len(jcfg.block_pattern)])
    x = np.random.default_rng(4).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    want, wc = JL.apply_attention(jparams["mixer"], jnp.asarray(x), jcfg,
                                  JPOL, mixer_kind=mixer, return_cache=True)
    got, gc = L.apply_attention(tp["blocks"][i]["mixer"], torch.from_numpy(x),
                                cfg, POL, mixer_kind=mixer, return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(gc[key].numpy(), np.asarray(wc[key]),
                                   **TOL)


def test_geglu_mlp():
    """GeGLU: gelu_tanh(x wg) * (x wi), then wo (layers.py:802-806)."""
    jcfg, cfg, jp, tp = _model("gemma2-27b")
    assert cfg.mlp_kind == "geglu"
    x = np.random.default_rng(5).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    jmlp = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"][0]["mlp"])
    want = JL.apply_mlp(jmlp, jnp.asarray(x), jcfg, JPOL)
    got = L.apply_mlp(tp["blocks"][0]["mlp"], torch.from_numpy(x), cfg, POL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scaled_embedding_rounds_the_scale_in_bf16():
    """At d_model 4608 sqrt(d) = 67.88 is 68.0 in bf16; the port scales by
    the rounded value, bit for bit as the reference (layers.py:840-841),
    and not by 67.88."""
    jcfg = dataclasses.replace(jget_config("gemma2-27b"), vocab_size=8)
    cfg = dataclasses.replace(get_config("gemma2-27b"), vocab_size=8)
    tok = (0.02 * np.random.default_rng(6).standard_normal(
        (8, cfg.d_model))).astype(np.float32)
    ids = np.array([[0, 3, 7, 3], [5, 1, 2, 6]], np.int32)
    jpol, pol = jmake_policy("bf16"), make_policy("bf16")
    want = JL.embed_tokens({"tok": jnp.asarray(tok)}, jnp.asarray(ids), jcfg,
                           jpol)
    got = L.embed_tokens({"tok": torch.from_numpy(tok)},
                         torch.from_numpy(ids), cfg, pol)
    assert got.dtype == torch.bfloat16
    want_f = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want_f)
    unrounded = (torch.from_numpy(tok)[torch.from_numpy(ids).long()].to(
        torch.bfloat16) * float(np.sqrt(cfg.d_model))).float().numpy()
    assert not np.array_equal(unrounded, want_f)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_leaf_for_leaf(arch):
    """``params_from_jax`` and ``params_to_numpy`` carry postnorm1/2,
    bq/bk/bv and a missing lm_head both ways, bit for bit; the port's own
    init makes the same leaves with the same shapes as the reference's."""
    jcfg, cfg, jp, tp = _model(arch)
    block = tp["blocks"][0]
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)
    assert ("postnorm1" in block) == cfg.post_block_norm
    assert ("bq" in block["mixer"]) == cfg.qkv_bias
    back = jax.tree_util.tree_leaves_with_path(bridge.params_to_numpy(tp, cfg))
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jp))
    assert [p for p, _ in back] == [p for p, _ in want]
    for (path, a), (_, b) in zip(back, want):
        assert np.array_equal(a, b), path
    own = bridge.params_to_numpy(T.init_model(cfg, seed=0, device="cpu"),
                                 cfg)
    shapes = {jax.tree_util.keystr(p): x.shape
              for p, x in jax.tree_util.tree_leaves_with_path(own)}
    assert shapes == {jax.tree_util.keystr(p): x.shape for p, x in want}
    if cfg.qkv_bias:   # zeros at init, as the reference's
        assert not T.init_model(cfg, device="cpu")["blocks"][0]["mixer"][
            "bq"].any()


# ---------------------------------------------------------------------------
# forward, prefill, decode (twins of tests/test_serve.py:18, :46)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_apply_lm_matches_jax(arch):
    """Full forward at two blocks: logits at every position of (2, 40),
    past gemma2's 16-token window."""
    jcfg, cfg, jp, tp = _model(arch, 2)
    toks = _tokens(cfg, (2, 40), 2)
    want, _ = JT.apply_lm(jp, jnp.asarray(toks), jcfg, JPOL)
    got = T.apply_lm(tp, torch.from_numpy(toks), cfg, POL)
    assert got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_jax_and_forward(arch):
    """tests/test_serve.py:18 on the port: a 28-token prefill into caches
    of 40 (gemma2's 16-row rings roll) and 4 decode steps fed the true
    tokens; each step's logits within LOGIT_TOL of the reference's and of
    the port's own full forward at that position."""
    jcfg, cfg, jp, tp = _model(arch)
    b, s = 2, 32
    toks = _tokens(cfg, (b, s), 7)
    full = T.apply_lm(tp, torch.from_numpy(toks), cfg, POL)
    jstate = JT.init_decode_state(jcfg, b, s + 8, jnp.float32)
    tstate = T.init_decode_state(cfg, b, s + 8, torch.float32, device="cpu")
    jl, jstate = JT.prefill(jp, jnp.asarray(toks[:, :s - 4]), jcfg, JPOL,
                            state=jstate)
    tl, tstate = T.prefill(tp, torch.from_numpy(toks[:, :s - 4]), cfg, POL,
                           state=tstate)
    for t in range(s - 4, s + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, t - 1].numpy(),
                                   **LOGIT_TOL)
        if t == s:
            break
        tok = toks[:, t:t + 1]
        jl, jstate = _jdecode(jcfg.arch_id)(jp, jnp.asarray(tok), jstate)
        tl, tstate = T.decode_step(tp, torch.from_numpy(tok), tstate, cfg,
                                   POL)
    assert tstate["pos"].tolist() == np.asarray(jstate["pos"]).tolist()


def test_ring_decode_past_the_window():
    """tests/test_serve.py:46 on the port: gemma2's local layers keep a
    ring of 16 rows; an 8-token prefill and decode to position 48 (three
    windows) equal the reference's decode and the full forward."""
    jcfg, cfg, jp, tp = _model("gemma2-27b")
    assert cfg.sliding_window == 16
    b, s = 1, 48
    toks = _tokens(cfg, (b, s), 8)
    full = T.apply_lm(tp, torch.from_numpy(toks), cfg, POL)
    tstate = T.init_decode_state(cfg, b, s, torch.float32, device="cpu")
    assert tstate["blocks"][0]["cache"]["k"].shape[1] == cfg.sliding_window
    assert tstate["blocks"][1]["cache"]["k"].shape[1] == s
    jstate = JT.init_decode_state(jcfg, b, s, jnp.float32)
    jl, jstate = JT.prefill(jp, jnp.asarray(toks[:, :8]), jcfg, JPOL,
                            state=jstate)
    tl, tstate = T.prefill(tp, torch.from_numpy(toks[:, :8]), cfg, POL,
                           state=tstate)
    for t in range(8, s):
        tok = toks[:, t:t + 1]
        jl, jstate = _jdecode(jcfg.arch_id)(jp, jnp.asarray(tok), jstate)
        tl, tstate = T.decode_step(tp, torch.from_numpy(tok), tstate, cfg,
                                   POL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, t].numpy(),
                                   **LOGIT_TOL, err_msg=f"pos {t}")


def test_prefill_wider_than_the_ring_rolls():
    """A raw prefill of 40 tokens into gemma2's 16-row rings keeps
    positions 24..39, position p at row p % 16 (rolled by 40 % 16), as the
    reference's ``_fit_cache``; 8 decode steps after it equal the
    reference's and the full forward."""
    jcfg, cfg, jp, tp = _model("gemma2-27b")
    b, p, s = 2, 40, 48
    toks = _tokens(cfg, (b, s), 9)
    jstate = JT.init_decode_state(jcfg, b, s, jnp.float32)
    tstate = T.init_decode_state(cfg, b, s, torch.float32, device="cpu")
    jl, jstate = JT.prefill(jp, jnp.asarray(toks[:, :p]), jcfg, JPOL,
                            state=jstate)
    tl, tstate = T.prefill(tp, torch.from_numpy(toks[:, :p]), cfg, POL,
                           state=tstate)
    ring = tstate["blocks"][0]["cache"]["k"]
    np.testing.assert_allclose(ring.numpy(),
                               np.asarray(jstate["blocks"][0]["cache"]["k"])[0],
                               **TOL)
    # row r holds position 24 + ((r - 40) mod 16): the K of the prompt's
    # last 16 positions, RoPE at their own positions
    _, nc = L.apply_attention(
        tp["blocks"][0]["mixer"],
        L.apply_norm(tp["blocks"][0]["norm1"], L.embed_tokens(
            tp["embed"], torch.from_numpy(toks[:, :p]), cfg, POL), cfg, POL),
        cfg, POL, mixer_kind="attn_local", return_cache=True)
    rows = [(24 + (r - p) % 16) for r in range(16)]
    np.testing.assert_array_equal(ring.numpy(), nc["k"][:, rows].numpy())
    full = T.apply_lm(tp, torch.from_numpy(toks), cfg, POL)
    for t in range(p, s):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, t - 1].numpy(),
                                   **LOGIT_TOL)
        tok = toks[:, t:t + 1]
        jl, jstate = _jdecode(jcfg.arch_id)(jp, jnp.asarray(tok), jstate)
        tl, tstate = T.decode_step(tp, torch.from_numpy(tok), tstate, cfg,
                                   POL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_apply_lm_at_640_takes_the_windowed_flash_route(monkeypatch):
    """At S 640 (S^2 > 512^2, S % 128 == 0) gemma2's attention goes to the
    flash forward, on the CPU its plain version, with window 16 on the
    local layer and 0 on the global one, softcap 50 on both; the logits
    equal the reference's chunk scan (layers.py:396-411)."""
    jcfg, cfg, jp, tp = _model("gemma2-27b")
    calls = []
    real = kops.flash_attention

    def spy(*a, **kw):
        calls.append((a[0].shape, kw["window"], kw["softcap"]))
        return real(*a, **kw)
    monkeypatch.setattr(kops, "flash_attention", spy)
    toks = _tokens(cfg, (1, 640), 10)
    want, _ = JT.apply_lm(jp, jnp.asarray(toks), jcfg, JPOL)
    got = T.apply_lm(tp, torch.from_numpy(toks), cfg, POL)
    assert calls == [((1, cfg.n_heads, 640, cfg.head_dim), 16, 50.0),
                     ((1, cfg.n_heads, 640, cfg.head_dim), 0, 50.0)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

def test_rings_refuse_a_paged_cache():
    """A sliding-window ring cannot be paged (transformer.py:94-95)."""
    cfg = smoke_variant(get_config("gemma2-27b"))
    with pytest.raises(ValueError, match="sliding-window"):
        T.init_decode_state(cfg, 2, 32, paged=T.PagedCacheConfig(
            page_size=4, num_pages=17), device="cpu")


@pytest.mark.parametrize("change,match", [
    (dict(qk_norm=True), "query/key norms"),
    (dict(pos_kind="mrope"), "M-RoPE"),
    (dict(block_pattern=(("attn", "moe"),)), "MoE"),
    (dict(block_pattern=(("mamba", "dense"),)), "mamba")])
def test_later_slices_stay_refused(change, match):
    cfg = dataclasses.replace(smoke_variant(get_config("deepseek-7b")),
                              **change)
    with pytest.raises(NotImplementedError, match=match):
        T.check_supported(cfg)
