"""The MoE's backward against the JAX package: ``jax.vjp`` of the
reference's ``_router``, ``_moe_single`` (at the config's capacity factor
and with drops forced) and ``moe_dense`` against the port's autograd on the
same numpy inputs and cotangents, in f32 and bf16; ``jax.grad`` of
``lm_train_loss`` with the router's aux loss for both MoE decoders on the
dense and the capacity path, the recompute on; the recompute routing as
the forward did; and the capacity path's graph, which holds no operation
whose CUDA backward adds with atomics in an order that changes from run to
run (``models/moe.py``'s docstring).

Inputs and weights are ``tests/test_torch_moe.py``'s (router std 0.1,
experts at 1/sqrt(fan-in), so the top-k margins are wide); the models are
``tests/test_torch_moe_serve.py``'s perturbed smoke weights.  The two
MoE decoders' smoke variants share their MoE shapes (d 256, 4 experts
top-2, expert d_ff 512), so the functions are taken at those and at a
wider routing.  The reference's functions are jitted (eager JAX compiles
each operation on its first call, ~4x the time here).  Tolerances: f32
gradients within 1e-4 relative, 1e-6 of the leaf's largest element
absolute (summation order only); bf16 gradients within BF16_GRAD_REL_L2
relative L2 (both packages round the expert products' inputs and outputs
to bf16, at other places)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.amp import make_policy as jmake_policy
from repro.models import api as japi
from repro.models import moe as JM
from repro_torch import bridge
from repro_torch.core.amp import make_policy
from repro_torch.models import api
from repro_torch.models import moe as M
from repro_torch.utils import tree_leaves, tree_map
from test_torch_moe import _cfgs, _weights, _x
from test_torch_moe_serve import ARCHS, _model, _tokens
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

WEIGHTS = ("router", "wi", "wg", "wo")
F32_GRAD_RTOL, F32_GRAD_ATOL = 1e-4, 1e-6
# readings on the CPU: 8.8e-3 worst (the router's, through the capacity
# path's combine at capacity factor 0.5), the experts' and the tokens'
# 3.9-5.6e-3; 2**-8 is bf16's rounding step
BF16_GRAD_REL_L2 = 2e-2
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _grad_close(got, want, precision, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if precision == "f32":
        np.testing.assert_allclose(
            got, want, rtol=F32_GRAD_RTOL,
            atol=F32_GRAD_ATOL * float(np.abs(want).max()), err_msg=what)
        return
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_GRAD_REL_L2, (what, rel)


def _vjp_both(jfn, tfn, args, seed):
    """The cotangents of ``jfn``'s outputs drawn from ``seed`` (in each
    output's dtype); returns (reference input cotangents, the port's), in
    the order of ``args`` (numpy float32 arrays)."""
    jouts, vjp = jax.vjp(jax.jit(jfn), *[jnp.asarray(a) for a in args])
    rng = np.random.default_rng(seed)
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c).astype(o.dtype)
                       for c, o in zip(cots, jouts)))
    targs = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    touts = tfn(*targs)
    tgrads = torch.autograd.grad(
        touts, targs, [torch.from_numpy(c).to(o.dtype)
                       for c, o in zip(cots, touts)])
    return jgrads, tgrads


def _routing(experts, top_k):
    change = {} if experts is None else dict(n_experts=experts,
                                             top_k=top_k)
    return _cfgs("granite-moe-3b-a800m", **change)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("experts,top_k", [(None, None), (40, 8)])
def test_router_vjp_matches_jax(experts, top_k, precision):
    """The router's probabilities, top-k weights and aux loss pulled back
    to the router's weights and the tokens, at the smoke routing and at
    granite's 40 experts top-8: the top-k's backward puts the weights'
    cotangents (through their renormalisation) on the chosen
    probabilities, the aux loss's on P_e alone (f_e counts, no
    gradient).  The router computes in f32 under either policy."""
    jcfg, cfg = _routing(experts, top_k)
    w = _weights(cfg)
    xt = _x(cfg, (40,))
    jpol, pol = jmake_policy(precision), make_policy(precision)

    def jfn(r, x):
        probs, _, topk_w, aux = JM._router({"router": r}, x, jcfg, jpol)
        return probs, topk_w, aux

    def tfn(r, x):
        probs, _, topk_w, aux = M._router({"router": r}, x, cfg, pol)
        return probs, topk_w, aux
    jg, tg = _vjp_both(jfn, tfn, (w["router"], xt), 5)
    for name, g, want in zip(("router", "x"), tg, jg):
        _grad_close(g, want, precision, name)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("capacity_factor,drops", [(1.25, None),
                                                   (0.5, "some")])
def test_moe_single_vjp_matches_jax(capacity_factor, drops, precision):
    """The capacity path pulled back to the router, the three expert
    weights and the tokens, at the reference's T of 2 x 16 (granite's
    smoke routing, 4 experts top-2): C 20 at the config's 1.25 and 8 at
    0.5, where drops are forced and a dropped slot passes no gradient to
    its expert."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m")
    w = _weights(cfg)
    xt = _x(cfg, (2, 16)).reshape(-1, cfg.d_model)
    jpol, pol = jmake_policy(precision), make_policy(precision)
    if drops:
        c = max(1, -(-int(32 * cfg.top_k * capacity_factor) //
                     cfg.n_experts))
        _, idx, _, _ = M._router({"router": torch.from_numpy(w["router"])},
                                 torch.from_numpy(xt), cfg, pol)
        assert not M._dispatch_indices(idx, cfg.n_experts, c)[1].all()

    def jfn(r, wi, wg, wo, x):
        return JM._moe_single({"router": r, "wi": wi, "wg": wg, "wo": wo},
                              x, jcfg, jpol, capacity_factor)

    def tfn(r, wi, wg, wo, x):
        return M._moe_single({"router": r, "wi": wi, "wg": wg, "wo": wo},
                             x, cfg, pol, capacity_factor)
    jg, tg = _vjp_both(jfn, tfn, tuple(w[k] for k in WEIGHTS) + (xt,), 6)
    for name, g, want in zip(WEIGHTS + ("x",), tg, jg):
        _grad_close(g, want, precision, name)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("experts,top_k", [(None, None), (8, 3)])
def test_moe_dense_vjp_matches_jax(experts, top_k, precision):
    """The oracle pulled back to every weight and the tokens (3 x 8
    tokens), at the smoke routing and at 8 experts top-3: the router's
    weights get the cotangent of the top-k weights through the combine,
    every expert the gradient of every token its weight is nonzero
    for."""
    jcfg, cfg = _routing(experts, top_k)
    w = _weights(cfg)
    x = _x(cfg, (3, 8))
    jpol, pol = jmake_policy(precision), make_policy(precision)

    def jfn(r, wi, wg, wo, xx):
        return JM.moe_dense({"router": r, "wi": wi, "wg": wg, "wo": wo}, xx,
                            jcfg, jpol)

    def tfn(r, wi, wg, wo, xx):
        return M.moe_dense({"router": r, "wi": wi, "wg": wg, "wo": wo}, xx,
                           cfg, pol)
    jg, tg = _vjp_both(jfn, tfn, tuple(w[k] for k in WEIGHTS) + (x,), 7)
    for name, g, want in zip(WEIGHTS + ("x",), tg, jg):
        _grad_close(g, want, precision, name)


# ---------------------------------------------------------------------------
# the whole loss
# ---------------------------------------------------------------------------

def _port_grads(tp, cfg, loss_of):
    """(loss, metrics, gradients in the reference's layout, numpy)."""
    tparams = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    leaves = tree_leaves(tparams)
    loss, metrics = loss_of(tparams)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss, metrics, bridge.params_to_numpy(
        tree_map(lambda _: next(grads), tparams), cfg)


@pytest.mark.parametrize("moe_impl", ["dense", "a2a"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_loss_gradients_match_jax(arch, moe_impl):
    """``jax.grad`` of the reference's ``lm_train_loss`` (the aux loss
    added at the config's 0.01, the recompute on) against the port's
    autograd at two blocks on (2, 25) tokens: the loss, lm_loss and
    router_aux, and every gradient leaf, the router and the three expert
    weights of each block included."""
    jcfg, cfg, jp, tp = _model(arch, 2)
    toks = _tokens(cfg, (2, 25), 8)
    jpol, pol = jmake_policy("f32"), make_policy("f32")
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: japi.lm_train_loss(p, {"tokens": t}, jcfg, jpol,
                                        moe_impl=moe_impl, remat=True),
        has_aux=True))(jp, jnp.asarray(toks))
    loss, m, tgrads = _port_grads(tp, cfg, lambda p: api.lm_train_loss(
        p, {"tokens": torch.from_numpy(toks)}, cfg, pol, moe_impl=moe_impl,
        remat=True))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    for k in ("lm_loss", "router_aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS_TOL)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(tgrads)[0])
    assert len(jflat) == len(tflat)
    assert any("router" in jax.tree_util.keystr(p) for p, _ in jflat)
    for path, want in jflat:
        _grad_close(torch.from_numpy(tflat[path]), want, "f32",
                    jax.tree_util.keystr(path))


@pytest.mark.parametrize("moe_impl", ["dense", "a2a"])
def test_the_recompute_routes_as_the_forward_did(monkeypatch, moe_impl):
    """Under the recompute each MoE layer routes twice, in the forward and
    again in the backward, to the same experts with the same weights (and
    on the capacity path the same slots), and the gradients, the router's
    by the aux loss included, are the ones without the recompute, bit for
    bit."""
    _, cfg, _, tp = _model("qwen3-moe-30b-a3b", 2)
    toks = torch.from_numpy(_tokens(cfg, (2, 25), 9))
    pol = make_policy("f32")
    routes, dispatches = [], []
    real_router, real_dispatch = M._router, M._dispatch_indices

    def router(*a, **k):
        out = real_router(*a, **k)
        routes.append([t.detach().clone() for t in out])
        return out

    def dispatch(*a, **k):
        out = real_dispatch(*a, **k)
        dispatches.append([t.clone() for t in out])
        return out
    monkeypatch.setattr(M, "_router", router)
    monkeypatch.setattr(M, "_dispatch_indices", dispatch)
    grads = {}
    for remat in (False, True):
        routes.clear()
        dispatches.clear()
        grads[remat] = _port_grads(tp, cfg, lambda p: api.lm_train_loss(
            p, {"tokens": toks}, cfg, pol, moe_impl=moe_impl,
            remat=remat, aux_coef=1.0))[2]
    # with the recompute: block 0's and 1's forward, then the backward's
    # recompute of block 1 and of block 0
    assert len(routes) == 4
    assert len(dispatches) == (0 if moe_impl == "dense" else 4)
    for rec in (routes, dispatches):
        for first, again in ((0, 3), (1, 2)) if rec else ():
            for a, b in zip(rec[first], rec[again]):
                assert torch.equal(a, b)
    for path, g in jax.tree_util.tree_flatten_with_path(grads[True])[0]:
        want = dict(jax.tree_util.tree_flatten_with_path(grads[False])[0])
        np.testing.assert_array_equal(g, want[path],
                                      err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# no atomic accumulation in the backward
# ---------------------------------------------------------------------------

# autograd nodes whose CUDA backward sums colliding indices with atomics,
# in an order that changes from launch to launch: the backward of
# index_select (repeat_interleave of a tensor is one) and of
# embedding-style gathers is an index_add_
ATOMIC_BACKWARD = ("IndexSelectBackward", "RepeatInterleaveBackward",
                   "EmbeddingBackward", "IndexAddBackward")


def _graph_nodes(out):
    seen, todo, names = set(), [out.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("impl", ["dense", "a2a"])
def test_the_moe_backward_has_no_atomic_accumulation(impl):
    """The graph of ``moe_apply`` (tokens and every weight requiring
    grad) holds none of ATOMIC_BACKWARD: a token's k copies for the
    capacity buffer are a broadcast view, whose backward sums the k axis
    in one order.  Its gathers' backwards (``IndexBackward0``: an
    accumulating ``index_put_``) collide only on the zero row, whose
    gradient is cut off."""
    _, cfg = _cfgs("granite-moe-3b-a800m")
    tw = {k: torch.from_numpy(v).requires_grad_()
          for k, v in _weights(cfg).items()}
    x = torch.from_numpy(_x(cfg, (2, 16))).requires_grad_()
    out, aux = M.moe_apply(tw, x, cfg, make_policy("bf16"), impl=impl)
    names = _graph_nodes(out.float().sum() + aux)
    assert "MmBackward0" in names or "BmmBackward0" in names
    bad = [n for n in names if n.startswith(ATOMIC_BACKWARD)]
    assert not bad, bad
    if impl == "a2a":
        assert "ExpandBackward0" in names
