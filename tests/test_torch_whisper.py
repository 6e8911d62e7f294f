"""whisper-small, the encoder-decoder, on the port against the JAX
package at ``smoke_variant`` sizes (``tests/torch_whisper.py``: 2 encoder
and 2 decoder layers, d 256, 16 frames, perturbed weights carried across
by ``bridge``):

* the config copy field by field, ``param_count`` and ``smoke_variant``;
* the encoder (the frames plus ``enc_pos``, bidirectional layers,
  ``enc_norm``), the cross sublayer in its prefill form (K and V from the
  encoder's output, returned as the cross cache) and its decode form
  (read from the cache), ``embed_tokens`` at a (B,) per-slot offset, and
  ``apply_lm``'s logits in f32 and bf16;
* the bidirectional attention at 20 frames, off the 128 grid, through
  the flash pair's plain versions, against the reference's;
* the plain path: ``impl="torch"`` reaches every LayerNorm and bias-GELU
  call of a forward, a prefill and a decode step;
* ``profile_serve``'s spans of an encoder-decoder, which do not nest.

The serving twins are in ``tests/test_torch_whisper_serve.py``, training
in ``tests/test_torch_whisper_train.py``.  The reference's functions are
jitted, each built once a module."""
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
from repro_torch.configs import ARCHS, cut_depth, get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.kernels import ops as kops
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from torch_whisper import (ARCH, JPOL, LOGIT_TOL, POL, frames, model,
                           rel_l2, tokens)
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

# f32 logits of the whole model: rel L2 (summation order only; ~5e-7 on
# the CPU)
F32_LOGIT_REL_L2 = 1e-5
# chip_smoke.py's LOGIT_REL_L2_BOUND for bf16 (the decoders' bound)
BF16_LOGIT_REL_L2 = 5e-2


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_config_matches_the_reference():
    """Every field of the full config and of the smoke variant (2 encoder
    layers, 16 frames, 4096 positions), the parameter count (the encoder
    layers and every decoder layer's cross projections, as the reference
    counts them: ~288 M at full size), the capabilities; the registry and
    the support checks take whisper, and qwen2-vl since its slice; ``cut_depth``
    cuts the encoder too; the port's parameter tree has the reference's
    leaves and shapes both ways."""
    assert ARCH in ARCHS
    for full in (True, False):
        cfg, jcfg = get_config(ARCH), jget_config(ARCH)
        if not full:
            cfg, jcfg = smoke_variant(cfg), jsmoke(jcfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert dataclasses.asdict(cfg.decode_caps) == dataclasses.asdict(
            jcfg.decode_caps)
        T.check_supported(cfg)
        api.check_trainable(cfg)
    assert get_config(ARCH).param_count() == 288_382_464
    small = smoke_variant(get_config(ARCH))
    assert (small.n_enc_layers, small.enc_seq, small.max_position) == (
        2, 16, 4096)
    cut = cut_depth(get_config(ARCH), 2)
    assert (cut.n_layers, cut.n_enc_layers, cut.d_model) == (2, 2, 768)
    vl = get_config("qwen2-vl-7b")
    assert "qwen2-vl-7b" in ARCHS and vl.n_vision_tokens == 256
    for c in (vl, smoke_variant(vl)):
        T.check_supported(c)
        api.check_trainable(c)
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
    assert len(tp["enc_blocks"]) == 2 and "cross" in tp["blocks"][1]


# ---------------------------------------------------------------------------
# the encoder, the cross sublayer and the embedding
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jencode():
    jcfg = model()[0]

    def enc(p, f):
        e = f.astype(JPOL.compute_dtype) + p["enc_pos"][None]
        e, _, _ = JT._run_blocks(p["enc_blocks"], e, jcfg, JPOL,
                                 jcfg.enc_block_pattern)
        return JL.apply_norm(p["enc_norm"], e, jcfg, JPOL)
    return jax.jit(enc)


def test_encoder_matches_the_reference():
    """The encoder's output (the cross sublayers' K and V source) from the
    same frames: 2 bidirectional layers (LayerNorm, attention through the
    flash pair's plain version, the bias-GELU MLP) and ``enc_norm``."""
    _, cfg, jp, tp = model()
    f = frames(cfg, 2, 11)
    want = _jencode()(jp, jnp.asarray(f))
    got = T._encode(tp, torch.from_numpy(f), cfg, POL)
    assert got.shape == (2, cfg.enc_seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


@pytest.mark.parametrize("form", ["prefill", "decode"])
def test_cross_sublayer_matches_the_reference(form):
    """``apply_attention(static_kv=True)`` of decoder layer 1: in its
    prefill form K and V are projected from the encoder's output and
    returned as the cross cache (the same values); in its decode form one
    token's query reads them verbatim from a cache and returns that
    cache, unwritten.  No mask, no positions."""
    jcfg, cfg, jp, tp = model()
    enc = _jencode()(jp, jnp.asarray(frames(cfg, 2, 12)))
    s = 7 if form == "prefill" else 1
    x = np.random.default_rng(13).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    jparams = _layer(jp["blocks"][0], 1)["cross"]
    tparams = tp["blocks"][1]["cross"]
    jy, jcache = JL.apply_attention(jparams, jnp.asarray(x), jcfg, JPOL,
                                    kv_source=enc, static_kv=True,
                                    return_cache=True)
    if form == "prefill":
        y, cache = L.apply_attention(
            tparams, torch.from_numpy(x), cfg, POL,
            kv_source=torch.from_numpy(np.array(enc)), static_kv=True,
            return_cache=True)
    else:
        given = {k: torch.from_numpy(np.array(v))
                 for k, v in jcache.items()}
        jy, _ = JL.apply_attention(jparams, jnp.asarray(x), jcfg, JPOL,
                                   cache=jcache, static_kv=True,
                                   return_cache=True)
        y, cache = L.apply_attention(tparams, torch.from_numpy(x), cfg, POL,
                                     cache=given, static_kv=True,
                                     return_cache=True)
        assert cache is given
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LOGIT_TOL)
    for k in ("k", "v"):
        assert cache[k].shape == (2, cfg.enc_seq, cfg.n_kv_heads,
                                  cfg.head_dim)
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **LOGIT_TOL)


@pytest.mark.parametrize("offset", ["per_slot", "scalar", "zero"])
def test_embed_tokens_at_an_offset(offset):
    """Learned positions at ``pos_offset``: a (B,) tensor (each slot its
    own, as a decode step passes ``state["pos"]``), a 0-d tensor and the
    Python 0 of training and prefill, against the reference's."""
    jcfg, cfg, jp, tp = model()
    toks = tokens(cfg, (3, 4), 14)
    off = {"per_slot": np.array([0, 9, 1000], np.int32),
           "scalar": np.array(37, np.int32), "zero": 0}[offset]
    want = JL.embed_tokens(jp["embed"], jnp.asarray(toks), jcfg, JPOL,
                           pos_offset=jnp.asarray(off))
    got = L.embed_tokens(tp["embed"], torch.from_numpy(toks), cfg, POL,
                         pos_offset=off if offset == "zero"
                         else torch.from_numpy(off))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the whole forward
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _japply(precision):
    jcfg = model()[0]
    pol = jmake_policy(precision)
    return jax.jit(lambda p, t, f: JT.apply_lm(p, t, jcfg, pol,
                                               enc_frames=f)[0])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_apply_lm_logits_match_the_reference(precision):
    """``apply_lm``'s logits from the same tokens and frames: f32 within
    F32_LOGIT_REL_L2, bf16 (each package's own roundings) within the
    decoders' bf16 bound; without frames an encoder-decoder raises."""
    _, cfg, jp, tp = model()
    toks, f = tokens(cfg, (2, 12), 15), frames(cfg, 2, 16)
    want = np.asarray(_japply(precision)(jp, jnp.asarray(toks),
                                         jnp.asarray(f)), np.float32)
    got = T.apply_lm(tp, torch.from_numpy(toks), cfg,
                     make_policy(precision),
                     enc_frames=torch.from_numpy(f)).float().numpy()
    assert got.shape == (2, 12, cfg.vocab_size) and np.isfinite(got).all()
    bound = F32_LOGIT_REL_L2 if precision == "f32" else BF16_LOGIT_REL_L2
    assert rel_l2(got, want) <= bound
    with pytest.raises(ValueError, match="enc_frames"):
        T.apply_lm(tp, torch.from_numpy(toks), cfg, POL)


def test_bidirectional_attention_off_the_grid():
    """The encoder's self-attention at 20 frames (off the 128-row tile
    grid): the port's ``attn_bidir`` through ``kops.flash_attention_vjp``
    (its plain versions on the CPU, forward and backward) against the
    reference's (its jnp ``naive_attention`` at this length), the output
    and the gradients of x and of the four projections."""
    jcfg, cfg, jp, tp = model()
    jcfg = dataclasses.replace(jcfg, enc_seq=20)
    cfg = dataclasses.replace(cfg, enc_seq=20)
    x = np.random.default_rng(17).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    dy = np.random.default_rng(18).standard_normal(x.shape).astype(
        np.float32)
    jparams = _layer(jp["enc_blocks"][0], 1)["mixer"]

    def jloss(p, x):
        y, _ = JL.apply_attention(p, x, jcfg, JPOL, mixer_kind="attn_bidir")
        return jnp.sum(y * dy), y
    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(x))
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tp["enc_blocks"][1]["mixer"].items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = L.apply_attention(params, xt, cfg, POL, mixer_kind="attn_bidir")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **LOGIT_TOL)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jgx).max()))
    for k, g in jgp.items():
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(g),
                                   rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the plain path and the profile's spans
# ---------------------------------------------------------------------------

def _recorded(monkeypatch, names):
    """Every call of ``kops.<name>`` appends its ``impl`` to
    ``calls[name]``."""
    calls = {n: [] for n in names}
    for n in names:
        real = getattr(kops, n)

        def rec(*a, impl=None, _n=n, _real=real, **k):
            calls[_n].append(impl)
            return _real(*a, impl=impl, **k)
        monkeypatch.setattr(kops, n, rec)
    return calls


@pytest.mark.parametrize("impl", [None, "torch"])
def test_impl_reaches_every_layernorm_and_bias_gelu(monkeypatch, impl):
    """``impl`` is threaded through every LayerNorm (the encoder's two a
    layer, the decoder's three -- the cross sublayer's too -- and both
    final norms) and every bias-GELU of a forward, a slot prefill and a
    decode step, so ``impl="torch"`` runs the plain versions throughout
    (``chip_smoke.py``'s plain path compares kernels with plain, not
    kernels with kernels)."""
    _, cfg, _, tp = model()
    enc, dec = cfg.n_enc_layers, cfg.n_layers
    calls = _recorded(monkeypatch, ("layernorm", "bias_gelu"))
    toks, f = tokens(cfg, (2, 6), 19), torch.from_numpy(frames(cfg, 2, 20))
    T.apply_lm(tp, torch.from_numpy(toks), cfg, POL, enc_frames=f,
               impl=impl)
    assert len(calls["layernorm"]) == 2 * enc + 3 * dec + 2
    assert len(calls["bias_gelu"]) == enc + dec
    state = T.init_decode_state(cfg, 2, 16, torch.float32, device="cpu",
                                enc_len=cfg.enc_seq)
    T.prefill(tp, torch.from_numpy(toks), cfg, POL, state=state,
              enc_frames=f, impl=impl)
    T.decode_step(tp, torch.from_numpy(toks[:, :1]), state, cfg, POL,
                  impl=impl)
    assert len(calls["layernorm"]) == 2 * (2 * enc + 3 * dec + 2) + 3 * dec + 1
    assert len(calls["bias_gelu"]) == 2 * (enc + dec) + dec
    assert set(calls["layernorm"]) == set(calls["bias_gelu"]) == {impl}


def test_profile_spans_do_not_nest():
    """``profile_serve``'s spans on a whisper forward: the encoder once
    (its layers' attention and MLP count inside it, no span of their
    own), and a decoder layer's self-attention, cross sublayer and MLP
    each once a layer."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import profile_serve as PS
    _, cfg, _, tp = model()
    toks, f = tokens(cfg, (1, 6), 21), torch.from_numpy(frames(cfg, 1, 22))
    with PS._spanned(), profile(activities=[ProfilerActivity.CPU]) as prof:
        T.apply_lm(tp, torch.from_numpy(toks), cfg, POL, enc_frames=f)
    counts = {e.key[len(PS.SPAN_PREFIX):]: e.count
              for e in prof.key_averages()
              if e.key.startswith(PS.SPAN_PREFIX)}
    assert counts == {"encoder": 1, "attention": cfg.n_layers,
                      "cross_attention": cfg.n_layers,
                      "mlp": cfg.n_layers}
