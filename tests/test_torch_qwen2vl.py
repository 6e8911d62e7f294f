"""qwen2-vl-7b, the vision-language decoder, on the port against the JAX
package at ``smoke_variant`` sizes (``tests/torch_qwen2vl.py``: 2 layers,
d 256, 4 heads of 32 over 1 KV head, M-RoPE sections (8, 4, 4), 8 vision
tokens, perturbed weights carried across by ``bridge``):

* the config copy field by field, ``param_count``, ``decode_caps`` and
  ``ASSIGNED``;
* ``apply_mrope`` at random distinct (3, B, S) triples in both section
  layouts, (8, 4, 4) at Dh 32 and (16, 24, 24) at Dh 128, against the
  reference's (f32, within 1e-5), and equal to ``apply_rope`` at equal
  triples (the twin of ``tests/test_attention.py:45``);
* ``apply_lm`` with vision embeddings and distinct triples, in f32 and
  bf16; ``prefill`` and ``decode_step`` with both, contiguous and paged;
* the overwrite, each axis of the triples and their sections reaching the
  logits; a prompt shorter than the vision tokens refused;
* ``bridge``'s leaves both ways.

Serving is in ``tests/test_torch_qwen2vl_serve.py``, training in
``tests/test_torch_qwen2vl_train.py``.  The reference's functions are
jitted, each built once a module."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.amp import make_policy as jmake_policy
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import ASSIGNED, cut_depth, get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from torch_qwen2vl import (ARCH, JPOL, LOGIT_TOL, POL, model, rel_l2,
                           tokens, triples, vision)
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

# apply_mrope in f32: the same fp32 products on both sides
MROPE_TOL = dict(rtol=1e-5, atol=1e-5)
# f32 logits of the whole model: rel L2 (summation order only)
F32_LOGIT_REL_L2 = 1e-5
# chip_smoke.py's LOGIT_REL_L2_BOUND for bf16 (the decoders' bound)
BF16_LOGIT_REL_L2 = 5e-2
# an input change that must reach the logits moves them by more than this
# relative L2 (f32, where the same inputs give the same bits).  The width
# section holds the 4 slowest of the 16 frequencies (3e-5 rad a position
# and less at theta 1e6): redrawing that axis up to 4096 moves the logits
# by ~8e-4, the other changes by more
MOVED = 1e-4


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_config_matches_the_reference():
    """Every field of the full config and of the smoke variant (sections
    (8, 4, 4), 8 vision tokens), the parameter count (the reference's:
    7,615,616,512 whole, 2,022,229,504 at 4 layers, 1,556,113,920 at 2),
    the capabilities (pageable, not prefix-shareable) and the list of
    assigned families."""
    for full in (True, False):
        cfg, jcfg = get_config(ARCH), jget_config(ARCH)
        if not full:
            cfg, jcfg = smoke_variant(cfg), jsmoke(jcfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert dataclasses.asdict(cfg.decode_caps) == dataclasses.asdict(
            jcfg.decode_caps)
        T.check_supported(cfg)
    full = get_config(ARCH)
    assert [cut_depth(full, n).param_count() for n in (28, 4, 2)] == [
        7_615_616_512, 2_022_229_504, 1_556_113_920]
    small = smoke_variant(full)
    assert (small.mrope_sections, small.n_vision_tokens) == ((8, 4, 4), 8)
    caps = full.decode_caps
    assert caps.pageable and not caps.prefix_shareable
    assert list(ASSIGNED) == list(JASSIGNED)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

LAYOUTS = [(32, (8, 4, 4)), (128, (16, 24, 24))]


@pytest.mark.parametrize("dh,sections", LAYOUTS)
def test_apply_mrope_matches_the_reference(dh, sections):
    """(3, B, S) triples whose three axes are drawn apart, so each
    frequency slot turns by its own section's axis: the port's rotation of
    (B, S, H, Dh) against the reference's, at theta 1e6 (qwen2-vl's) and
    positions up to 4096."""
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 9, 3, dh)).astype(np.float32)
    pos = triples(2, 9, dh, high=4096)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                        sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MROPE_TOL)
    got16 = L.apply_mrope(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(pos), 1e6, sections)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("dh,sections", LAYOUTS)
def test_mrope_degenerates_to_rope(dh, sections):
    """The twin of ``tests/test_attention.py:45``: at equal triples M-RoPE
    is RoPE, in both section layouts."""
    b, s = 2, 64
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, s, 4, dh)).astype(np.float32))
    pos = torch.arange(s)[None].expand(b, s)
    np.testing.assert_allclose(
        L.apply_rope(q, pos, 1e4).numpy(),
        L.apply_mrope(q, pos[None].expand(3, b, s), 1e4, sections).numpy(),
        **MROPE_TOL)


def test_position_encode_checks_its_positions():
    """``position_encode`` takes (B, S) under RoPE and (3, B, S) under
    M-RoPE and raises otherwise; sections that do not sum to Dh/2
    raise."""
    _, cfg, _, _ = model()
    q = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="mrope"):
        L.position_encode(q, q, torch.zeros((1, 4), dtype=torch.long), cfg)
    rope = dataclasses.replace(cfg, pos_kind="rope")
    with pytest.raises(ValueError, match="rope"):
        L.position_encode(q, q, torch.zeros((3, 1, 4), dtype=torch.long),
                          rope)
    with pytest.raises(ValueError, match="sum"):
        L.apply_mrope(q, torch.zeros((3, 1, 4), dtype=torch.long), 1e4,
                      (8, 4, 3))


# ---------------------------------------------------------------------------
# the whole forward
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _japply(precision):
    jcfg = model()[0]
    pol = jmake_policy(precision)
    return jax.jit(lambda p, t, v, pos: JT.apply_lm(
        p, t, jcfg, pol, vision_embeds=v, positions=pos)[0])


def _apply(tp, cfg, toks, vis=None, pos=None, pol=POL):
    return T.apply_lm(
        tp, torch.from_numpy(toks), cfg, pol,
        vision_embeds=None if vis is None else torch.from_numpy(vis),
        positions=None if pos is None else torch.from_numpy(pos))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_apply_lm_matches_the_reference(precision):
    """``apply_lm``'s logits from the same tokens, vision embeddings over
    the first 8 positions and distinct triples: f32 within
    F32_LOGIT_REL_L2, bf16 (each package's own roundings) within the
    decoders' bf16 bound."""
    _, cfg, jp, tp = model()
    toks, vis, pos = tokens(cfg, (2, 20), 3), vision(cfg, 2, 4), \
        triples(2, 20, 5)
    want = np.asarray(_japply(precision)(
        jp, jnp.asarray(toks), jnp.asarray(vis), jnp.asarray(pos)),
        np.float32)
    got = _apply(tp, cfg, toks, vis, pos,
                 make_policy(precision)).float().numpy()
    assert got.shape == (2, 20, cfg.vocab_size) and np.isfinite(got).all()
    bound = F32_LOGIT_REL_L2 if precision == "f32" else BF16_LOGIT_REL_L2
    assert rel_l2(got, want) <= bound


def test_default_triples_are_arange_on_every_axis():
    """Without ``positions`` the forward takes ``arange(S)`` on the three
    axes, as the reference's; with the vision embeddings and without, as
    the reference's (the same jitted function given those triples)."""
    _, cfg, jp, tp = model()
    toks, vis = tokens(cfg, (2, 16), 6), vision(cfg, 2, 7)
    ar = np.broadcast_to(np.arange(16, dtype=np.int32)[None, None],
                         (3, 2, 16)).copy()
    want = np.asarray(_japply("f32")(jp, jnp.asarray(toks), jnp.asarray(vis),
                                     jnp.asarray(ar)))
    got = _apply(tp, cfg, toks, vis).numpy()
    assert rel_l2(got, want) <= F32_LOGIT_REL_L2
    np.testing.assert_array_equal(got, _apply(tp, cfg, toks, vis, ar).numpy())


@pytest.mark.parametrize("change", ["vision", "temporal", "height", "width",
                                    "sections"])
def test_each_input_reaches_the_logits(change):
    """What a port that dropped a piece of the slice would still pass
    elsewhere: the logits move (relative L2 above MOVED) when the vision
    embeddings are left out, when one axis of the triples is redrawn, and
    when the sections are reordered ((4, 4, 8) against (8, 4, 4): the
    slots read other axes)."""
    _, cfg, _, tp = model()
    toks, vis, pos = tokens(cfg, (2, 20), 8), vision(cfg, 2, 9), \
        triples(2, 20, 10)
    base = _apply(tp, cfg, toks, vis, pos).numpy()
    other_cfg, other_vis, other_pos = cfg, vis, pos.copy()
    if change == "vision":
        other_vis = None
    elif change == "sections":
        other_cfg = dataclasses.replace(cfg, mrope_sections=(4, 4, 8))
    else:
        axis = ("temporal", "height", "width").index(change)
        other_pos[axis] = triples(2, 20, 11)[axis]
    moved = _apply(tp, other_cfg, toks, other_vis, other_pos).numpy()
    assert rel_l2(moved, base) > MOVED


def test_a_prompt_shorter_than_the_vision_tokens_is_refused():
    """A prompt of fewer tokens than the vision embeddings raises
    ``ValueError`` in ``apply_lm`` and ``prefill`` (the reference would
    fail on a shape); one of exactly that many is all vision."""
    _, cfg, _, tp = model()
    vis = torch.from_numpy(vision(cfg, 1, 12))
    short = torch.from_numpy(tokens(cfg, (1, cfg.n_vision_tokens - 1), 13))
    with pytest.raises(ValueError, match="vision"):
        T.apply_lm(tp, short, cfg, POL, vision_embeds=vis)
    state = T.init_decode_state(cfg, 1, 16, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="vision"):
        T.prefill(tp, short, cfg, POL, state=state, vision_embeds=vis)
    exact = torch.from_numpy(tokens(cfg, (1, cfg.n_vision_tokens), 14))
    a = T.apply_lm(tp, exact, cfg, POL, vision_embeds=vis)
    b = T.apply_lm(tp, torch.zeros_like(exact), cfg, POL, vision_embeds=vis)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jprefill():
    jcfg = model()[0]
    return jax.jit(lambda p, t, v, pos, st: JT.prefill(
        p, t, jcfg, JPOL, state=st, vision_embeds=v, positions=pos))


@functools.lru_cache(maxsize=None)
def _jdecode():
    jcfg = model()[0]
    return jax.jit(functools.partial(JT.decode_step, cfg=jcfg, policy=JPOL))


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
@pytest.mark.parametrize("given", ["triples", "arange"])
def test_prefill_and_decode_match_the_reference(cache, given):
    """A 14-token prefill with vision embeddings (distinct triples, or the
    default ones) and 4 decode steps at the slots' positions broadcast to
    the three axes: each step's logits within LOGIT_TOL of the
    reference's (its contiguous cache), the port's in a contiguous or a
    paged cache (pages of 4), and the positions after it equal."""
    jcfg, cfg, jp, tp = model()
    b, s, new = 2, 14, 4
    toks, vis = tokens(cfg, (b, s + new), 15), vision(cfg, b, 16)
    pos = triples(b, s, 17) if given == "triples" else None
    jstate = JT.init_decode_state(jcfg, b, s + new, jnp.float32)
    paged = None
    if cache == "paged":
        paged = T.PagedCacheConfig(page_size=4, num_pages=1 + b * 5)
    tstate = T.init_decode_state(cfg, b, s + new, torch.float32,
                                 paged=paged, device="cpu")
    if paged is not None:
        T.set_block_tables(tstate, 1 + np.arange(b * 5, dtype=np.int32)
                           .reshape(b, 5))
    jl, jstate = _jprefill()(jp, jnp.asarray(toks[:, :s]), jnp.asarray(vis),
                             None if pos is None else jnp.asarray(pos),
                             jstate)
    tl, tstate = T.prefill(
        tp, torch.from_numpy(toks[:, :s]), cfg, POL, state=tstate,
        vision_embeds=torch.from_numpy(vis),
        positions=None if pos is None else torch.from_numpy(pos))
    for t in range(s, s + new + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"pos {t}")
        if t == s + new:
            break
        tok = toks[:, t:t + 1]
        jl, jstate = _jdecode()(jp, jnp.asarray(tok), jstate)
        tl, tstate = T.decode_step(tp, torch.from_numpy(tok), tstate, cfg,
                                   POL)
    assert tstate["pos"].tolist() == np.asarray(jstate["pos"]).tolist()


def test_decode_positions_broadcast_to_three_axes():
    """``_decode_positions`` of per-slot positions (B,) and of a scalar
    start: (B, S) under RoPE, the same on the three axes (3, B, S) under
    M-RoPE."""
    _, cfg, _, _ = model()
    p = T._decode_positions(torch.tensor([3, 7]), 2, 1, cfg)
    assert p.shape == (3, 2, 1) and p[:, :, 0].tolist() == [[3, 7]] * 3
    rope = dataclasses.replace(cfg, pos_kind="rope")
    q = T._decode_positions(torch.tensor(5), 2, 3, rope)
    assert q.tolist() == [[5, 6, 7], [5, 6, 7]]


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------

def test_bridge_leaves_both_ways():
    """The port's parameter tree has the reference's leaves and shapes
    (QKV biases, an untied ``lm_head``), and a reference tree goes through
    ``params_from_jax`` and back in the same bits."""
    jcfg, cfg, jp, tp = model()
    want = jax.tree_util.tree_map(
        np.shape, jax.eval_shape(lambda k: JT.init_model(k, jcfg)[0],
                                 jax.random.PRNGKey(0)))
    got = jax.tree_util.tree_map(np.shape, bridge.params_to_numpy(
        T.init_model(cfg, seed=3, device="cpu"), cfg))
    assert got == want
    back = bridge.params_to_numpy(tp, cfg)
    assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(np.asarray(a), b)), jp, back)))
    layer = tp["blocks"][0]["mixer"]
    assert {"bq", "bk", "bv"} <= set(layer) and "lm_head" in tp
