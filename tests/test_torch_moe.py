"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``) at the smoke variants of
granite-moe-3b-a800m and qwen3-moe-30b-a3b (4 experts, top-2, d 256,
expert d_ff 512), and at a wider router (40 experts, top-8: granite's
routing at full width) where the routing alone is compared.

Inputs and weights are drawn with numpy from a seed and handed to both
packages, so their routers read the same fp32 logits.  The router weights
are drawn at std 0.1 (logits of std ~1.6 at d 256) and the expert weights
at 1/sqrt(fan-in), so that the outputs are O(1) and the top-k margins wide.
Tolerances: f32 outputs 1e-5 (the frameworks differ in summation order
only); bf16 outputs within 2e-2 elementwise and 1e-2 relative L2 (the
expert products and the weighted combine rounded to bf16 at other places,
2**-8 relative each); dispatch indices exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.amp import make_policy as jmake_policy
from repro.models import moe as JM
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import moe as M
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_REL_L2 = 1e-2
# a top-k choice may differ only where the k-th and (k+1)-th probabilities
# of a token lie closer than this (fp32 softmax of the same logits: the
# packages' summation orders differ by a few ulps)
MARGIN = 1e-6


def _cfgs(arch, **change):
    jcfg, cfg = jsmoke(jget_config(arch)), smoke_variant(get_config(arch))
    if change:
        import dataclasses
        jcfg = dataclasses.replace(jcfg, **change)
        cfg = dataclasses.replace(cfg, **change)
    return jcfg, cfg


def _weights(cfg, seed=0):
    """numpy router (d, E), wi, wg (E, d, f) and wo (E, f, d)."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {"router": (0.1 * rng.standard_normal((d, e))).astype(np.float32),
            "wi": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(
                np.float32),
            "wg": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(
                np.float32),
            "wo": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(
                np.float32)}


def _both(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v.copy()) for k, v in w.items()})


def _x(cfg, shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _pols(precision):
    return jmake_policy(precision), make_policy(precision)


def _close(got, want, precision):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if precision == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    np.testing.assert_allclose(got, want, **BF16_TOL)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL_L2, rel


def _same_choices(got_idx, want_idx, probs, k):
    """Identical top-k choices but where the k-th / (k+1)-th margin of a
    token is below MARGIN; returns the share of identical (token, slot)
    choices."""
    got_idx, want_idx = np.asarray(got_idx), np.asarray(want_idx)
    srt = -np.sort(-np.asarray(probs), axis=-1)
    close = (srt[:, k - 1] - srt[:, k] < MARGIN) if srt.shape[-1] > k else \
        np.zeros(len(srt), bool)
    differ = (got_idx != want_idx).any(-1)
    assert not (differ & ~close).any(), np.flatnonzero(differ & ~close)
    return float((got_idx == want_idx).mean())


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,experts,top_k", [
    ("granite-moe-3b-a800m", None, None), ("qwen3-moe-30b-a3b", None, None),
    ("granite-moe-3b-a800m", 40, 8)])
def test_router_matches_jax(arch, experts, top_k):
    """Probabilities (fp32, 1e-6), the top-k choices (identical but at
    near ties, MARGIN), the renormalised weights and the Switch aux loss
    E * sum f_e P_e, at the smoke width's 4 experts top-2 and at granite's
    40 experts top-8."""
    change = {} if experts is None else dict(n_experts=experts, top_k=top_k)
    jcfg, cfg = _cfgs(arch, **change)
    jw, tw = _both(_weights(cfg))
    x = _x(cfg, (48,))
    jpol, pol = _pols("f32")
    jp, ji, jwt, ja = JM._router(jw, jnp.asarray(x), jcfg, jpol)
    tp, ti, twt, ta = M._router(tw, torch.from_numpy(x), cfg, pol)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    share = _same_choices(ti.numpy(), ji, jp, cfg.top_k)
    assert share == 1.0
    np.testing.assert_allclose(twt.numpy(), np.asarray(jwt), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(twt.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert ta.dtype == torch.float32 and ta.shape == ()
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_router_aux_is_one_when_balanced():
    """Uniform probabilities (P_e = 1/E) give aux = E * sum f_e / E = 1
    whichever experts the top-k takes; one expert at probability ~1, in
    every token's top-k (f_e = 1/k), gives aux ~E/k."""
    _, cfg = _cfgs("granite-moe-3b-a800m")
    pol = make_policy("f32")
    e = cfg.n_experts
    x = torch.ones((8, cfg.d_model))
    flat = {"router": torch.zeros((cfg.d_model, e))}
    _, idx, _, aux = M._router(flat, x, cfg, pol)
    assert float(aux) == pytest.approx(1.0, rel=1e-6)
    peaked = {"router": torch.zeros((cfg.d_model, e))}
    peaked["router"][:, 0] = 1.0
    _, idx, w, aux = M._router(peaked, x, cfg, pol)
    assert (idx[:, 0] == 0).all()
    assert float(aux) == pytest.approx(e * (1 / cfg.top_k), rel=1e-3)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("experts,top_k,tokens,capacity", [
    (4, 2, 32, 1), (4, 2, 32, 5), (4, 2, 32, 20), (4, 2, 32, 64),
    (40, 8, 30, 1), (40, 8, 30, 4), (40, 8, 30, 7), (128, 8, 9, 1)])
def test_dispatch_indices_match_jax_exactly(experts, top_k, tokens,
                                            capacity):
    """``dest`` and ``keep`` identical to the reference's for skewed
    assignments (expert 0 and 1 drawn 5x as often, so capacities of 1-7
    drop in token order) and capacities from 1 to no drop."""
    rng = np.random.default_rng(experts + tokens + capacity)
    p = np.ones(experts)
    p[:2] = 5.0
    idx = np.stack([rng.choice(experts, size=top_k, replace=False,
                               p=p / p.sum()) for _ in range(tokens)])
    idx = idx.astype(np.int32)
    jd, jk = JM._dispatch_indices(jnp.asarray(idx), experts, capacity)
    td, tk = M._dispatch_indices(torch.from_numpy(idx).long(), experts,
                                 capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    # every expert keeps its first min(n_e, C) assignments in token order
    counts = np.bincount(idx.reshape(-1), minlength=experts)
    assert int(tk.sum()) == int(np.minimum(counts, capacity).sum())
    assert (td[~tk] == experts * capacity).all()
    assert len(set(td[tk].tolist())) == int(tk.sum())


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_group_and_combine_match_jax(precision):
    """``_group_local``'s (E, C, d) buffers and ``_combine_local``'s
    weighted (T, d) sum against the reference's, at a capacity that drops
    (C 6 for 32 x 2 assignments over 4 experts)."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m")
    jw, tw = _both(_weights(cfg))
    x = _x(cfg, (32,))
    jpol, pol = _pols(precision)
    _, ji, jwt, _ = JM._router(jw, jnp.asarray(x), jcfg, jpol)
    _, ti, twt, _ = M._router(tw, torch.from_numpy(x), cfg, pol)
    xc = torch.from_numpy(x).to(pol.compute_dtype)
    jg, jd, jk = JM._group_local(jnp.asarray(x).astype(jpol.compute_dtype),
                                 ji, jwt, cfg.n_experts, 6)
    tg, td, tk = M._group_local(xc, ti, twt, cfg.n_experts, 6)
    assert not tk.all()
    assert torch.equal(tg, torch.from_numpy(
        np.array(jg.astype(jnp.float32))).to(tg.dtype))
    proc = np.random.default_rng(3).standard_normal(
        (cfg.n_experts, 6, cfg.d_model)).astype(np.float32)
    want = JM._combine_local(jnp.asarray(proc).astype(jpol.compute_dtype),
                             jd, jk, jwt, 32, cfg.top_k, cfg.d_model)
    got = M._combine_local(torch.from_numpy(proc).to(pol.compute_dtype),
                           td, tk, twt, 32, cfg.top_k, cfg.d_model)
    assert got.dtype == pol.compute_dtype
    _close(got, want, precision)


# ---------------------------------------------------------------------------
# the expert products, the oracle and the capacity path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_expert_ffn_matches_jax(precision):
    """SwiGLU over (E, C, d) grouped tokens, three batched products in the
    compute dtype."""
    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b")
    w = _weights(cfg)
    jw, tw = _both(w)
    x = np.random.default_rng(2).standard_normal(
        (cfg.n_experts, 7, cfg.d_model)).astype(np.float32)
    jpol, pol = _pols(precision)
    want = JM._expert_ffn(jw["wi"], jw["wg"], jw["wo"], jnp.asarray(x), jcfg,
                          jpol)
    got = M._expert_ffn(tw["wi"], tw["wg"], tw["wo"], torch.from_numpy(x),
                        cfg, pol)
    assert got.dtype == pol.compute_dtype and got.shape == x.shape
    _close(got, want, precision)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_jax(arch, precision):
    """Every expert on every token, combined by the router's weights in
    the compute dtype: (B, S, d) outputs and the aux loss."""
    jcfg, cfg = _cfgs(arch)
    jw, tw = _both(_weights(cfg))
    x = _x(cfg, (2, 12))
    jpol, pol = _pols(precision)
    want, jaux = JM.moe_dense(jw, jnp.asarray(x), jcfg, jpol)
    got, taux = M.moe_dense(tw, torch.from_numpy(x), cfg, pol)
    assert got.dtype == pol.compute_dtype and got.shape == x.shape
    _close(got, want, precision)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("capacity_factor,drops", [(1.25, None), (8.0, 0),
                                                   (0.5, "some")])
def test_moe_single_matches_jax(capacity_factor, drops, precision):
    """The capacity path at the reference's exact T: 2 rows of a 16-token
    bucket, 5 of the 32 tokens pad (id-0 embeddings, here a fixed row),
    routed and taking capacity as any other.  C = ceil(T k cf / E): 20 at
    cf 1.25 (some drops possible), 128 at cf 8 (none), 8 at cf 0.5 (drops
    forced, in token order): outputs and aux as the reference's, a dropped
    slot contributing 0, and no drop equal to ``moe_dense``."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m")
    jw, tw = _both(_weights(cfg))
    x = _x(cfg, (2, 16))
    x[0, 11:] = x[1, 14:] = x[0, 0]          # the bucket's pad rows
    xt = x.reshape(-1, cfg.d_model)
    jpol, pol = _pols(precision)
    want, jaux = JM._moe_single(jw, jnp.asarray(xt), jcfg, jpol,
                                capacity_factor)
    got, taux = M._moe_single(tw, torch.from_numpy(xt), cfg, pol,
                              capacity_factor)
    _close(got, want, precision)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    c = max(1, -(-int(32 * cfg.top_k * capacity_factor) // cfg.n_experts))
    _, idx, _, _ = M._router(tw, torch.from_numpy(xt), cfg, pol)
    _, keep = M._dispatch_indices(idx, cfg.n_experts, c)
    if drops == 0:
        assert keep.all()
        dense, _ = M.moe_dense(tw, torch.from_numpy(x), cfg, pol)
        torch.testing.assert_close(got, dense.reshape(got.shape),
                                   rtol=1e-5 if precision == "f32" else 2e-2,
                                   atol=1e-5 if precision == "f32" else 2e-2)
    elif drops == "some":
        assert (~keep).sum() > 0
        # a token whose assignments all dropped gets exactly 0
        gone = (~keep.reshape(32, cfg.top_k)).all(-1)
        assert gone.any() and (got[gone] == 0).all()


@pytest.mark.parametrize("impl", ["dense", "a2a", "replicated"])
def test_moe_apply_matches_jax_without_a_mesh(impl):
    """Without a mesh the reference's ``a2a`` and ``replicated`` are the
    capacity path at ``cfg.capacity_factor``; ``dense`` is the oracle."""
    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b")
    jw, tw = _both(_weights(cfg))
    x = _x(cfg, (3, 8))
    jpol, pol = _pols("f32")
    want, jaux = JM.moe_apply(jw, jnp.asarray(x), jcfg, jpol, impl=impl)
    got, taux = M.moe_apply(tw, torch.from_numpy(x), cfg, pol, impl=impl)
    _close(got, want, "f32")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_moe_apply_refuses_a_model_axis_and_unknown_impls():
    """A ``model`` axis wider than 1 (the reference's expert-parallel mesh
    paths) raises ``NotImplementedError``; an impl name the reference
    does not know raises ``ValueError`` (the reference without a mesh
    would run the capacity path for any name)."""
    _, cfg = _cfgs("granite-moe-3b-a800m")
    tw = _both(_weights(cfg))[1]
    x = torch.from_numpy(_x(cfg, (1, 4)))
    pol = make_policy("f32")
    for impl in M.MOE_IMPLS:
        with pytest.raises(NotImplementedError, match="model"):
            M.moe_apply(tw, x, cfg, pol, impl=impl, model_axis=2)
        M.moe_apply(tw, x, cfg, pol, impl=impl, model_axis=1)
    with pytest.raises(ValueError, match="moe impl"):
        M.moe_apply(tw, x, cfg, pol, impl="sparse")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_shapes_and_scales(arch):
    """The reference's leaf shapes; std 0.02 truncated at 2 std, ``wo``'s
    scaled by 1/sqrt(2 n_layers)."""
    import jax
    jcfg, cfg = _cfgs(arch)
    jp, _ = JM.init_moe(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    tp = M.init_moe(cfg, gen)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for name, std in (("router", 0.02), ("wi", 0.02),
                      ("wo", 0.02 / np.sqrt(2 * cfg.n_layers))):
        t = tp[name]
        assert float(t.abs().max()) <= 2 * std + 1e-7
        assert float(t.std()) == pytest.approx(std * 0.88, rel=0.1)
