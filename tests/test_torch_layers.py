"""The port's decoder layers against ``repro.models.layers`` at f32: the
same numpy inputs go through both (RMSNorm, RoPE, attention with no cache,
a contiguous cache, bf16-style float pages and int8 pages, the paged prefill
write and page quantisation)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.amp import make_policy as jmake_policy
from repro.models import layers as JL
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import layers as L
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

JCFG = jsmoke(jget_config("deepseek-7b"))
CFG = smoke_variant(get_config("deepseek-7b"))
JPOL, POL = jmake_policy("f32"), make_policy("f32")
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _attn_params():
    p = JL.init_attention(jax.random.PRNGKey(3), JCFG)[0]
    return p, {k: _t(v) for k, v in p.items()}


def test_configs_match_the_reference():
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab_size", "rope_theta", "norm_eps"):
        assert getattr(CFG, name) == getattr(JCFG, name), name
    assert get_config("deepseek-7b").param_count() == \
        jget_config("deepseek-7b").param_count()
    assert CFG.decode_caps == get_config("deepseek-7b").decode_caps
    assert CFG.decode_caps.pageable and not CFG.decode_caps.windowed


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, CFG.d_model)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(CFG.d_model)).astype(np.float32)
    want = JL.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), JCFG,
                         JPOL)
    _close(L.apply_norm({"scale": _t(scale)}, _t(x), CFG, POL), want)


def test_rope_split_half():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 2000, (2, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    _close(L.apply_rope(_t(x), _t(pos), 10000.0), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [16, 640, 1024])
def test_attention_no_cache(s):
    """S=16 runs naive attention, S=640 the reference's chunk scan against
    the port's naive path, S=1024 the flash branch (its plain version on
    the CPU)."""
    jp, tp = _attn_params()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((1, s, CFG.d_model)).astype(np.float32)
    want, wc = JL.apply_attention(jp, jnp.asarray(x), JCFG, JPOL,
                                  return_cache=True)
    got, gc = L.apply_attention(tp, _t(x), CFG, POL, return_cache=True)
    _close(got, want, rtol=1e-4, atol=1e-5)
    _close(gc["k"], wc["k"], rtol=1e-4, atol=1e-5)
    _close(gc["v"], wc["v"], rtol=1e-4, atol=1e-5)


def test_attention_contiguous_decode():
    """Write at per-slot ring positions in place, attend kv_len rows."""
    jp, tp = _attn_params()
    rng = np.random.default_rng(4)
    b, length = 3, 12
    shape = (b, length, CFG.n_kv_heads, CFG.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((b, 1, CFG.d_model)).astype(np.float32)
    pos = np.asarray([0, 5, 11], np.int32)
    kvl = pos + 1
    want, wc = JL.apply_attention(
        jp, jnp.asarray(x), JCFG, JPOL, positions=jnp.asarray(pos[:, None]),
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cache_pos=jnp.asarray(pos), kv_len=jnp.asarray(kvl),
        return_cache=True)
    cache = {"k": _t(ck), "v": _t(cv)}
    got, gc = L.apply_attention(tp, _t(x), CFG, POL,
                                positions=_t(pos[:, None]), cache=cache,
                                cache_pos=_t(pos), kv_len=_t(kvl),
                                return_cache=True)
    assert gc is cache          # updated in place
    _close(got, want)
    _close(gc["k"], wc["k"])
    _close(gc["v"], wc["v"])


def _pool(rng, quantized, n_pages=7, ps=4):
    shape = (n_pages, ps, CFG.n_kv_heads, CFG.head_dim)
    if quantized:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        return {"k_pages": kp, "v_pages": vp,
                "k_scale": rng.uniform(0.005, 0.02, (n_pages, CFG.n_kv_heads))
                .astype(np.float32),
                "v_scale": rng.uniform(0.005, 0.02, (n_pages, CFG.n_kv_heads))
                .astype(np.float32)}
    return {"k_pages": rng.standard_normal(shape).astype(np.float32),
            "v_pages": rng.standard_normal(shape).astype(np.float32)}


@pytest.mark.parametrize("quantized", [False, True])
def test_attention_paged_decode(quantized):
    """Paged write (mid-page, fresh page, over capacity -> trash page) and
    read, float and int8 pages (the int8 append requantises the page)."""
    jp, tp = _attn_params()
    rng = np.random.default_rng(5)
    pool = _pool(rng, quantized)
    pool["block_table"] = np.asarray([[1, 2], [3, 4], [5, 6]], np.int32)
    x = rng.standard_normal((3, 1, CFG.d_model)).astype(np.float32)
    pos = np.asarray([2, 4, 8], np.int32)        # capacity is 2 x 4 = 8
    jcache = {k: jnp.asarray(v) for k, v in pool.items()}
    want, wc = JL.apply_attention(jp, jnp.asarray(x), JCFG, JPOL,
                                  positions=jnp.asarray(pos[:, None]),
                                  cache=jcache, cache_pos=jnp.asarray(pos),
                                  return_cache=True)
    tcache = {k: _t(v) for k, v in pool.items()}
    got, gc = L.apply_attention(tp, _t(x), CFG, POL,
                                positions=_t(pos[:, None]), cache=tcache,
                                cache_pos=_t(pos), return_cache=True)
    _close(got, want, rtol=1e-5, atol=1e-5)
    for key in pool:
        if key in ("k_pages", "v_pages") and quantized:
            assert np.array_equal(gc[key].numpy(), np.asarray(wc[key])), key
        else:
            _close(gc[key], wc[key])


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_prefill_write(quantized):
    rng = np.random.default_rng(6)
    pool = _pool(rng, quantized, n_pages=9)
    pool["block_table"] = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    k = rng.standard_normal((2, 10, CFG.n_kv_heads, CFG.head_dim)).astype(
        np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    valid = np.asarray([10, 6], np.int32)
    want = JL.paged_prefill_write({kk: jnp.asarray(vv)
                                   for kk, vv in pool.items()},
                                  jnp.asarray(k), jnp.asarray(v),
                                  valid_len=jnp.asarray(valid))
    tcache = {kk: _t(vv) for kk, vv in pool.items()}
    got = L.paged_prefill_write(tcache, _t(k), _t(v), valid_len=_t(valid))
    assert got is tcache
    for key in pool:
        if key in ("k_pages", "v_pages") and quantized:
            assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
        else:
            _close(got[key], want[key])


def test_quantize_pages():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 4, 2, 32)).astype(np.float32)
    x[1] = 0.0                   # an all-zero page keeps scale 0, ints 0
    wq, ws = JL.quantize_pages(jnp.asarray(x))
    tq, ts = L.quantize_pages(_t(x))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(wq))
    _close(ts, ws, rtol=0, atol=0)


def test_valid_token_mask():
    want = JL.valid_token_mask(jnp.asarray([3, 1]), 2, 5)
    got = L.valid_token_mask(torch.tensor([3, 1]), 2, 5)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert L.valid_token_mask(None, 2, 5) is None


def test_mlp_and_embedding():
    rng = np.random.default_rng(8)
    jm = JL.init_mlp(jax.random.PRNGKey(1), JCFG)[0]
    je = JL.init_embedding(jax.random.PRNGKey(2), JCFG)[0]
    x = rng.standard_normal((2, 3, CFG.d_model)).astype(np.float32)
    _close(L.apply_mlp({k: _t(v) for k, v in jm.items()}, _t(x), CFG, POL),
           JL.apply_mlp(jm, jnp.asarray(x), JCFG, JPOL), rtol=1e-4,
           atol=1e-5)
    toks = rng.integers(0, CFG.vocab_size, (2, 3)).astype(np.int32)
    _close(L.embed_tokens({"tok": _t(je["tok"])}, _t(toks), CFG, POL),
           JL.embed_tokens(je, jnp.asarray(toks), JCFG, JPOL), rtol=0,
           atol=0)


def test_contiguous_write_past_the_stripe_is_dropped():
    """A decode position at or past the stripe length writes nothing (the
    reference's out-of-bounds scatter drops it) and never touches the next
    slot's stripe."""
    _, tp = _attn_params()
    rng = np.random.default_rng(9)
    shape = (2, 4, CFG.n_kv_heads, CFG.head_dim)
    cache = {"k": _t(rng.standard_normal(shape).astype(np.float32)),
             "v": _t(rng.standard_normal(shape).astype(np.float32))}
    before = {k: v.clone() for k, v in cache.items()}
    x = _t(rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32))
    pos = torch.tensor([4, 2])
    L.apply_attention(tp, x, CFG, POL, positions=pos[:, None], cache=cache,
                      cache_pos=pos, kv_len=torch.tensor([4, 3]))
    for key in cache:
        assert torch.equal(cache[key][0], before[key][0])
        assert not torch.equal(cache[key][1, 2], before[key][1, 2])
        assert torch.equal(cache[key][1, :2], before[key][1, :2])


# ---------------------------------------------------------------------------
# the encoder subset (BERT)
# ---------------------------------------------------------------------------

JBERT = jsmoke(jget_config("bert-large"), d_model=128, n_blocks=2)
BERT = smoke_variant(get_config("bert-large"), d_model=128, n_blocks=2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layernorm_branch_with_the_config_eps(dtype):
    """``init_norm``/``apply_norm`` take ``norm_kind="layernorm"`` (they
    raised before) with ``cfg.norm_eps`` = 1e-12, not the kernel's 1e-6
    default: a row of near-equal values tells the two apart."""
    assert BERT.norm_eps == 1e-12
    p = L.init_norm(BERT)
    assert set(p) == {"scale", "bias"} and torch.equal(p["bias"],
                                                       torch.zeros(128))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    x[0, 0] *= 1e-4                         # variance ~1e-8
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(128)).astype(np.float32)
    jpol, pol = jmake_policy(dtype), make_policy(dtype)
    xj = jnp.asarray(x).astype(jpol.compute_dtype)
    want = JL.apply_norm({"scale": jnp.asarray(scale),
                          "bias": jnp.asarray(bias)}, xj, JBERT, jpol)
    got = L.apply_norm({"scale": _t(scale), "bias": _t(bias)},
                       _t(x).to(pol.compute_dtype), BERT, pol)
    assert got.dtype == pol.compute_dtype
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_gelu_mlp_and_learned_positions():
    rng = np.random.default_rng(6)
    jp = JL.init_mlp(jax.random.PRNGKey(4), JBERT)[0]
    jp = {k: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in jp.items()}                  # non-zero biases
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    want = JL.apply_mlp(jp, jnp.asarray(x), JBERT, JPOL)
    got = L.apply_mlp({k: _t(v) for k, v in jp.items()}, _t(x), BERT, POL)
    _close(got, want, rtol=1e-5, atol=1e-5)
    je = JL.init_embedding(jax.random.PRNGKey(5), JBERT)[0]
    assert je["pos"].shape == (512, 128)
    toks = rng.integers(0, BERT.vocab_size, (2, 37)).astype(np.int32)
    want = JL.embed_tokens(je, jnp.asarray(toks), JBERT, JPOL)
    got = L.embed_tokens({k: _t(v) for k, v in je.items()}, _t(toks), BERT,
                         POL)
    _close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("s", [16, 128, 200])
def test_bidirectional_attention(s):
    """``attn_bidir`` goes through the flash op (its plain version on the
    CPU) at every length; the reference takes naive attention there."""
    jp = JL.init_attention(jax.random.PRNGKey(6), JBERT)[0]
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 128)).astype(np.float32)
    want, _ = JL.apply_attention(jp, jnp.asarray(x), JBERT, JPOL,
                                 mixer_kind="attn_bidir")
    got, _ = L.apply_attention({k: _t(v) for k, v in jp.items()}, _t(x),
                               BERT, POL, mixer_kind="attn_bidir")
    _close(got, want, rtol=1e-4, atol=1e-5)
