"""Training RWKV-6 (rwkv6-1.6b, ``smoke_variant`` at 2 layers) against
the JAX package at f32: the same weights (``bridge.params_from_jax``, the
time mix's mixes, decays, norms and bonus drawn away from their init on
both sides) and the same numpy tokens.

* ``kops.wkv6_vjp``: the kernel's forward (here its plain version) with the
  VJP of the chunked form as its backward, against autograd through
  ``kernels.ref.wkv6_ref`` itself (the same bits), the reference's
  ``jax.vjp`` of ``wkv6_chunked`` and autograd through the step-by-step
  ``wkv6_sequential``: every input's gradient, the carried state's
  included, with and without a gradient of the final state;
* the loss and every gradient group through each package's
  ``lm_train_loss`` with the recompute, at S 64 (one chunk) and S 128 (two
  chunks: the state carried between them takes a gradient);
* one step of each package's ``train_step_fn`` under LAMB and AdamW at
  S 128, accumulation 2;
* the route: a call autograd records takes ``wkv6_vjp``, serving ``wkv6``;
* the twin of ``tests/test_cli.py::test_train_cli_dp_ring``: the trainer's
  CLI on rwkv6-1.6b, ``--dp --strategy ring``, f32, 4 steps of 8 x 32
  tokens on 4 gloo ranks (``launch.mesh.spawn``, ``torch_dp_workers``):
  every rank the same state digest and loss bits, every loss finite and
  within 1e-5 of the same run in one process.
"""
import functools
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import amp as jamp
from repro.models import api as japi
from repro.models import rwkv as JR
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.core import amp
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as M
from repro_torch.launch import train as train_cli
from repro_torch.models import api
from repro_torch.models import rwkv as RW
from repro_torch.train import train_step as ts
from repro_torch.utils import tree_leaves, tree_map
from test_torch_variants_step import (ADAMW_MOMENT_REL_L2,
                                      ADAMW_UPDATE_REL_L2, ADAMW_WELL,
                                      MASTER_TOL, MOMENT_TOL, SCALAR_TOL)

import torch_dp_workers as W
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

JCFG = jsmoke(jget_config("rwkv6-1.6b"), n_blocks=2)
CFG = smoke_variant(get_config("rwkv6-1.6b"), n_blocks=2)
# f32 on both sides: the chunked form is the same math in both, the sums
# in another order (XLA's fused reductions and matmul blocking).
# Readings on the CPU: the loss in the same bits, every gradient group
# within 2e-6 relative L2 and 5e-7 absolute; wkv6's input gradients
# within 9e-7 of the reference's and of the sequential form's, relative to
# each gradient's largest element.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
WKV_GRAD_TOL = 1e-5
POL = amp.make_policy("f32")
JPOL = jamp.make_policy("f32")


@functools.lru_cache(maxsize=None)
def _np_params(seed):
    jp = jax.jit(lambda key: japi.init_params(key, JCFG)[0])(
        jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, jp)


def _params(seed=0):
    """The reference's init with the mixes, decays, bonus and norms moved:
    at init the mixes are 0 and every channel decays alike."""
    np_params = jax.tree_util.tree_map(np.array, _np_params(seed))
    rng = np.random.default_rng(seed + 1)
    pos = np_params["blocks"][0]
    tm = pos["mixer"]
    for name, std in (("maa_x", 0.2), ("maa_wkvrg", 0.2), ("decay", 1.0),
                      ("ln_x_scale", 0.2), ("ln_x_bias", 0.2)):
        tm[name] = (tm[name] + std * rng.standard_normal(
            tm[name].shape)).astype(np.float32)
    for name in ("maa_k", "maa_r"):
        pos["mlp"][name] = (0.2 * rng.standard_normal(
            pos["mlp"][name].shape)).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, np_params), np_params


def _tokens(seed, b, s):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


def _wkv_inputs(seed, b=2, s=128, h=2, hs=64):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hs)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.uniform(-6, 0, (b, s, h, hs))).astype(np.float32)
    u = (0.5 * rng.standard_normal((h, hs))).astype(np.float32)
    s0 = rng.standard_normal((b, h, hs, hs)).astype(np.float32)
    do = rng.standard_normal((b, s, h, hs)).astype(np.float32)
    ds = rng.standard_normal((b, h, hs, hs)).astype(np.float32)
    return (r, k, v, logw, u, s0), do, ds


def _torch_grads(fn, ins, do, ds):
    ts_ = [torch.from_numpy(x).requires_grad_() for x in ins]
    o, s_final = fn(*ts_)
    outs, gs = [o], [torch.from_numpy(do)]
    if ds is not None:
        outs.append(s_final)
        gs.append(torch.from_numpy(ds))
    return [g.numpy() for g in torch.autograd.grad(outs, ts_, gs)]


@pytest.mark.parametrize("final_state", [True, False],
                         ids=["with-final-state", "output-only"])
def test_wkv6_vjp_matches_the_chunked_forms_gradient(final_state):
    """``wkv6_vjp`` at S 128 (two chunks) with every input taking a
    gradient: the same bits as autograd through ``wkv6_ref`` and on a
    second call; within WKV_GRAD_TOL (relative to each gradient's largest
    element) of the reference's ``jax.vjp`` of ``wkv6_chunked`` and of
    autograd through ``wkv6_sequential``.  Without a gradient of the final
    state (training) that output contributes nothing."""
    ins, do, ds = _wkv_inputs(3)
    ds = ds if final_state else None
    got = _torch_grads(lambda *a: ops.wkv6_vjp(*a), ins, do, ds)
    again = _torch_grads(lambda *a: ops.wkv6_vjp(*a), ins, do, ds)
    plain = _torch_grads(lambda *a: ref.wkv6_ref(*a), ins, do, ds)
    seq = _torch_grads(RW.wkv6_sequential, ins, do, ds)
    _, vjp = jax.vjp(lambda *a: JR.wkv6_chunked(*a, chunk=64),
                     *(jnp.asarray(x) for x in ins))
    jds = jnp.asarray(ds) if final_state else jnp.zeros(ins[5].shape)
    want = [np.asarray(g) for g in vjp((jnp.asarray(do), jds))]
    for name, g, a, p, q, w in zip(("r", "k", "v", "logw", "u", "s0"), got,
                                   again, plain, seq, want):
        assert g.tobytes() == a.tobytes() == p.tobytes(), name
        scale = np.abs(w).max()
        assert scale > 0, name
        assert np.abs(g - w).max() <= WKV_GRAD_TOL * scale, name
        assert np.abs(g - q).max() <= WKV_GRAD_TOL * scale, name


def test_recorded_calls_take_the_vjp_and_serving_the_forward(monkeypatch):
    """The time mix's unmasked route: under autograd ``kops.wkv6_vjp``
    (which calls the ``wkv6`` dispatcher once), under ``no_grad`` the
    dispatcher alone."""
    calls = {"wkv6": 0, "wkv6_vjp": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, real=real, name=name, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    _, np_params = _params()
    params = bridge.params_from_jax(np_params, CFG, device="cpu")
    tm = tree_map(lambda t: t.requires_grad_(), params["blocks"][0]["mixer"])
    x = torch.randn(2, 128, CFG.d_model)
    y, _ = RW.apply_time_mix(tm, x, CFG, POL)
    y.sum().backward()
    assert calls == {"wkv6": 1, "wkv6_vjp": 1}
    assert tm["u"].grad is not None and tm["decay"].grad.abs().max() > 0
    with torch.no_grad():
        RW.apply_time_mix(tm, x, CFG, POL)
    assert calls == {"wkv6": 2, "wkv6_vjp": 1}


@pytest.mark.parametrize("s", [64, 128])
def test_loss_and_every_gradient_match_the_reference(monkeypatch, s):
    """With the recompute: every layer's wkv6 forward runs twice (the
    recompute) and its backward is the chunked form's VJP."""
    jp, np_params = _params()
    tokens = _tokens(s, 2, s + 1)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: japi.lm_train_loss(p, {"tokens": t}, JCFG, JPOL,
                                        remat=True),
        has_aux=True))(jp, jnp.asarray(tokens))
    calls = {"n": 0}
    real = ops.wkv6

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(ops, "wkv6", counted)
    tparams = bridge.params_from_jax(np_params, CFG, device="cpu")
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = api.lm_train_loss(
        tparams, api.to_device({"tokens": tokens}, "cpu"), CFG, POL,
        remat=True)
    grads = torch.autograd.grad(loss, leaves)
    assert calls["n"] == 2 * CFG.n_layers
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(metrics["lm_loss"]),
                               float(jmet["lm_loss"]), **LOSS_TOL)
    it = iter(grads)
    tgrads = dict(jax.tree_util.tree_flatten_with_path(bridge.params_to_numpy(
        tree_map(lambda _: next(it), tparams), CFG))[0])
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tgrads) == 28     # 24 a layer's group + 4
    for path, want in jflat:
        assert np.abs(np.asarray(want)).max() > 0, path
        np.testing.assert_allclose(tgrads[path], np.asarray(want),
                                   **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _key(path):
    return tuple(k.key for k in path if hasattr(k, "key"))


@pytest.mark.parametrize("optimizer", ["lamb", "adamw"])
def test_train_step_matches_the_reference(optimizer):
    """One step of each package's ``train_step_fn`` at S 128 (2 x 129
    tokens in two micro-batches, the recompute on): loss, gradient norm,
    learning rate, every group's master and moments, held as the dense
    variants' step is (``tests/test_torch_variants_step.py``)."""
    jp, np_params = _params()
    kw = dict(precision="f32", accum_steps=2, optimizer=optimizer,
              learning_rate=2e-3, warmup_steps=1, total_steps=3)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = jts.init_train_state(jp, JPOL, jtcfg)
    state = ts.init_train_state(
        bridge.params_from_jax(np_params, CFG, device="cpu"), POL, tcfg,
        cfg=CFG)
    start = {p: t.clone() for p, t in
             state.opt.groups.stacked(state.opt.master).items()}
    tokens = _tokens(7, 2, 129)
    jstate, jm = jax.jit(partial(jts.train_step_fn, cfg=JCFG, tcfg=jtcfg,
                                 policy=JPOL))(
        jstate, {"tokens": jnp.asarray(tokens)})
    state, m = ts.train_step_fn(state, api.to_device({"tokens": tokens},
                                                     "cpu"),
                                cfg=CFG, tcfg=tcfg, policy=POL)
    assert state.opt.step == int(jstate.opt.step) == 1
    assert not m["skipped"] and not bool(jm["skipped"])
    for k in ("loss", "grad_norm", "lr", "lm_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **SCALAR_TOL,
                                   err_msg=k)
    grad = {_key(p): np.asarray(g) / (1 - 0.9) for p, g in
            jax.tree_util.tree_flatten_with_path(jstate.opt.m)[0]}
    for name, tol in (("master", MASTER_TOL), ("m", MOMENT_TOL),
                      ("v", MOMENT_TOL)):
        got = state.opt.groups.stacked(getattr(state.opt, name))
        want = jax.tree_util.tree_flatten_with_path(
            getattr(jstate.opt, name))[0]
        assert len(got) == len(want)
        for path, w in want:
            key = _key(path)
            g, w = got[key].numpy(), np.asarray(w)
            msg = f"{name} {key}"
            if optimizer == "lamb":
                np.testing.assert_allclose(g, w, **tol, err_msg=msg)
                continue
            if name == "master":
                well = np.abs(grad[key]) >= ADAMW_WELL
                g = (g - start[key].numpy())[well]
                w = (w - start[key].numpy())[well]
            bound = (ADAMW_UPDATE_REL_L2 if name == "master"
                     else ADAMW_MOMENT_REL_L2)
            assert np.linalg.norm(g - w) <= bound * np.linalg.norm(w), \
                (msg, np.linalg.norm(g - w) / np.linalg.norm(w))


RING_ARGV = ["--arch", "rwkv6-1.6b", "--steps", "4", "--batch", "8",
             "--seq", "32", "--dp", "--strategy", "ring", "--precision",
             "f32", "--device", "cpu", "--log-every", "1"]


def test_train_cli_dp_ring(tmp_path):
    """Twin of ``tests/test_cli.py::test_train_cli_dp_ring`` (the
    reference asserts its run exits 0): 4 gloo ranks, each 2 rows of every
    global batch, the ring exchange; every rank ends with the same state
    digest and loss bits, and the losses are finite and within 1e-5 of the
    same run in one process (the ring adds in another order)."""
    M.spawn(W.train_cli_rank, 4, args=(RING_ARGV, str(tmp_path)),
            device="cpu", timeout_s=60, wait_s=240)
    ranks = [json.loads((tmp_path / f"cli_rank{r}.json").read_text())
             for r in range(4)]
    assert len({r["digest"] for r in ranks}) == 1
    assert len({tuple(r["losses"]) for r in ranks}) == 1
    losses = [float.fromhex(h) for h in ranks[0]["losses"]]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    _, _, serial = train_cli.run([a for a in RING_ARGV if a != "--dp"])
    np.testing.assert_allclose(losses, [r["loss"] for r in serial],
                               rtol=1e-5)


# the port's bf16 gradient gaps (||g_bf16 - g_f32|| / ||g_f32||) against
# the reference's (jit) on the same weights: readings on the CPU at width
# 1024 (16 heads), 2 x 128 tokens, within 0.64-1.08x of the reference's
# (XLA keeps the ddlerp's mixes in f32 inside its fusions: the port's
# maa_x and maa_wkvrg gaps read 0.64-0.66x); u's 4.6e-2 falls to 6.8e-3,
# the bf16 floor of every other leaf, with the group norm's scale a
# constant
BF16_GAP_RATIO = (0.5, 1.5)
FLAT_NORM_GAP = 1e-2


def test_bf16_gradient_gaps_are_the_references():
    """rwkv's bf16 gradients of u, r's and k's weights lie far from f32
    when the model is wide (``tests/torch_rwkv_bf16_gap.py``): the time
    mix's per-head group norm makes each head's output scale-invariant,
    so their gradients are what its projection leaves of larger terms.
    The port's gap of every leaf of one time mix is the reference's, and
    with the norm's 1 / sqrt(var + eps) a constant (eps 1e6) every leaf's
    gap falls to bf16's own, u's by more than 5x."""
    import torch_rwkv_bf16_gap as G
    g = G.time_mix_gaps(d_model=1024, batch=2, seq=128, seed=1,
                        op_by_op=False)
    lo, hi = BF16_GAP_RATIO
    for leaf, gap in g["port"].items():
        assert lo * g["ref_jit"][leaf] <= gap <= hi * g["ref_jit"][leaf], \
            (leaf, gap, g["ref_jit"][leaf])
        assert g["port_flat_norm"][leaf] <= FLAT_NORM_GAP, leaf
    assert g["port"]["u"] > 5 * g["port_flat_norm"]["u"]
