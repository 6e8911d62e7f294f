"""The hybrid jamba-1.5-large-398b through the port's model entry points
against the JAX package at f32: the configs and parameter counts, the
bridge, the full forward, prefill and decode with every mamba row and
attention cache and greedy generation, each on the smoke variant's
8-layer block and on its first 4 layers
(``tests/torch_jamba.py``: the weights and tolerances;
``tests/test_torch_jamba_slots.py``: the slot prefill and its exactness;
``tests/test_torch_jamba_sched.py``: the scheduler, the adapter and the
CLIs).

The reference's aux loss of a multi-position block keeps the last
position's router loss only (its scan body overwrites ``aux`` at each
position), and so does the port's; serving discards it, and
tests/test_torch_jamba_train.py holds it against the reference."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import transformer as JT
from repro.serve import serve_step as JSS
from repro_torch import bridge
from repro_torch.configs import cut_depth, get_config, smoke_variant
from repro_torch.models import transformer as T
from repro_torch.serve import serve_step as SS
from torch_jamba import (ARCH, JPOL, LAYERS, LOGIT_TOL, POL,
                         assert_states_close, jcut, jdecode, model, tokens)
import torch_threads  # noqa: F401  (one PyTorch thread a worker)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "full_cut4", "smoke",
                                   "smoke_cut4"])
def test_configs_match_the_reference(which):
    """Every field, the parameter counts (all and active; the card's 4-layer
    cut is 23,020,593,152 and 6,109,159,424 a token), ``mamba_d_inner``,
    ``dt_rank`` and the serving capabilities equal the reference's; the
    port runs (mamba, dense) and (mamba, moe) layers."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    if which.startswith("smoke"):
        cfg, jcfg = smoke_variant(cfg), jsmoke(jcfg)
    if which.endswith("cut4"):
        cfg, jcfg = cut_depth(cfg, 4), jcut(jcfg, 4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for active in (False, True):
        assert cfg.param_count(active) == jcfg.param_count(active)
    assert (cfg.mamba_d_inner, cfg.dt_rank) == (jcfg.mamba_d_inner,
                                                jcfg.dt_rank)
    assert dataclasses.asdict(cfg.decode_caps) == dataclasses.asdict(
        jcfg.decode_caps)
    caps = cfg.decode_caps
    assert caps.pageable and caps.needs_exact_prefill
    assert not caps.prefix_shareable
    T.check_supported(cfg)
    if which == "full_cut4":
        assert cfg.param_count() == 23_020_593_152
        assert cfg.param_count(active_only=True) == 6_109_159_424
        assert cfg.block_pattern == (("attn", "dense"), ("mamba", "moe"),
                                     ("mamba", "dense"), ("mamba", "moe"))
    if which == "full":
        assert cfg.param_count() == 398_538_596_352


@pytest.mark.parametrize("layers,kept", [(4, 4), (8, 8), (16, 16),
                                          (12, None), (20, None)])
def test_cut_depth_keeps_a_prefix_or_whole_blocks(layers, kept):
    """``cut_depth`` keeps a prefix of the 8-layer block, or whole blocks;
    a depth past one block that is not a multiple of it is refused, so a
    CLI's ``--layers`` never counts another depth than it builds."""
    cfg = get_config(ARCH)
    if kept is None:
        with pytest.raises(ValueError, match="does not tile"):
            cut_depth(cfg, layers)
        return
    cut = cut_depth(cfg, layers)
    assert cut.n_layers == len(cut.layer_kinds()) == kept
    assert cut.layer_kinds() == (cfg.block_pattern * 2)[:kept]


@pytest.mark.parametrize("layers", LAYERS)
def test_bridge_carries_the_mamba_leaves_both_ways(layers):
    """Layer i is block i // P at position i % P; every leaf, the mamba
    mixer's nine among them, comes back bit for bit, and the port's own
    init has the reference's leaf shapes."""
    jcfg, cfg, jp, tp = model(layers)
    mixer = tp["blocks"][1]["mixer"]
    din, n, r = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.dt_rank
    assert {k: tuple(v.shape) for k, v in mixer.items()} == {
        "in_proj": (256, 2 * din), "conv_w": (4, din), "conv_b": (din,),
        "x_proj": (din, r + 2 * n), "dt_proj": (r, din), "dt_bias": (din,),
        "a_log": (din, n), "d_skip": (din,), "out_proj": (din, 256)}
    assert "router" in tp["blocks"][1]["mlp"]
    assert "wq" in tp["blocks"][0]["mixer"]
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

@pytest.mark.parametrize("layers", LAYERS)
def test_apply_lm_matches_jax(layers):
    """The full forward of (2, 24) tokens (the chunked scan, one chunk of
    24) against the reference's logits."""
    jcfg, cfg, jp, tp = model(layers)
    toks = tokens(cfg, (2, 24), 2)
    want, _ = jax.jit(functools.partial(JT.apply_lm, cfg=jcfg, policy=JPOL,
                                        moe_impl="dense"))(
        jp, jnp.asarray(toks))
    got = T.apply_lm(tp, torch.from_numpy(toks), cfg, POL, moe_impl="dense")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layers", LAYERS)
def test_prefill_decode_match_jax(layers, masked):
    """A 12-token prefill (unmasked: the chunked scan; with full-width
    ``lengths``: the masked sequential one) and 4 decode steps: each
    step's logits, every layer's ``conv`` and ``ssm`` rows and the
    attention layer's K/V against the reference's."""
    jcfg, cfg, jp, tp = model(layers)
    b, s = 2, 12
    toks = tokens(cfg, (b, s + 4), 7)
    kw = dict(moe_impl="dense")
    lengths = np.full((b,), s, np.int32) if masked else None
    jstate = JT.init_decode_state(jcfg, b, s + 8, jnp.float32)
    tstate = T.init_decode_state(cfg, b, s + 8, torch.float32, device="cpu")
    jl, jstate = jax.jit(functools.partial(
        JT.prefill, cfg=jcfg, policy=JPOL, **kw))(
            jp, jnp.asarray(toks[:, :s]), state=jstate,
            lengths=None if lengths is None else jnp.asarray(lengths))
    tl, tstate = T.prefill(
        tp, torch.from_numpy(toks[:, :s]), cfg, POL, state=tstate,
        lengths=None if lengths is None else torch.from_numpy(lengths), **kw)
    for t in range(s, s + 4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        assert_states_close(tstate, jstate)
        tok = toks[:, t:t + 1]
        jl, jstate = jdecode(layers)(jp, jnp.asarray(tok), jstate)
        tl, tstate = T.decode_step(tp, torch.from_numpy(tok), tstate, cfg,
                                   POL, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_states_close(tstate, jstate)
    assert tstate["pos"].tolist() == np.asarray(jstate["pos"]).tolist()


def test_greedy_generate_matches_jax():
    """Greedy generation of a (2, 10) prompt, 6 new tokens (the masked
    full-width prefill, as ``needs_exact_prefill`` asks), token for
    token, on the 8-layer block."""
    jcfg, cfg, jp, tp = model(8)
    prompt = tokens(cfg, (2, 10), 12)
    want = JSS.greedy_generate(jp, jnp.asarray(prompt), jcfg, JPOL,
                               max_new=6, max_len=32)
    got = SS.greedy_generate(tp, torch.from_numpy(prompt), cfg, POL,
                             max_new=6, max_len=32)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_greedy_matches_jax_on_the_cut():
    """The greedy runs the scheduler test holds against, on the 4-layer
    cut: token for token with the reference's greedy generation."""
    jcfg, cfg, jp, tp = model(4)
    prompt = tokens(cfg, (1, 9), 13)
    want = JSS.greedy_generate(jp, jnp.asarray(prompt), jcfg, JPOL,
                               max_new=6, max_len=32)
    got = SS.greedy_generate(tp, torch.from_numpy(prompt), cfg, POL,
                             max_new=6, max_len=32)
    assert np.array_equal(got.numpy(), np.asarray(want))
