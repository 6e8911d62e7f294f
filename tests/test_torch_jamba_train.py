"""Training the hybrid jamba-1.5-large-398b on the port against the JAX
package, at ``smoke_variant`` sizes: its 8-position block (d_model 256,
d_inner 512, 4 experts top-2), the port's init carried across with
``tests/torch_jamba.py``'s perturbations:

* ``lm_train_loss`` -- the training step's own loss: the capacity path,
  the recompute, the aux at 0.01 -- against ``jax.grad`` of the
  reference's, the port's recompute off and on: the loss, lm_loss and the
  router's aux as the reference's ``_run_blocks`` carries it (of each
  block its last pattern position's, summed over the blocks; the port
  summed every MoE layer's before), and every gradient, the 9 mamba
  leaves of each of the 7 mamba layers (``mamba._SelectiveScan``'s
  backward) and the routers of every position included;
* one LAMB and one AdamW step against the reference's, taken through its
  own ``_clip_grads`` and ``_optimizer_update`` on its gradient, at
  ``tests/test_torch_moe_train.py``'s tolerances;
* the optimizer groups against the reference's stacked tree (8
  positions), and checkpoints both ways.

The 4-layer cut, granite's one-position blocks, the cut by positions and
the CLI are in ``tests/test_torch_jamba_cuts.py``; the scan's backward
alone in ``tests/test_torch_mamba_grad.py``.  The reference's functions
are jitted, each built once a module."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import amp as jamp
from repro.models import api as japi
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro_torch import bridge
from repro_torch.configs import (TrainConfig, cut_depth, get_config,
                                 smoke_variant)
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.train import train_step as ts
from repro_torch.train.checkpoint import (load_manifest, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.utils import tree_leaves, tree_map
from test_torch_moe_grad import F32_GRAD_RTOL, LOSS_TOL
from test_torch_moe_train import (ADAMW_MOMENT_REL_L2, ADAMW_UPDATE_REL_L2,
                                  ADAMW_WELL, MASTER_TOL, MOMENT_TOL,
                                  SCALAR_TOL)
from torch_jamba import ARCH, JPOL, POL, jcut, perturbed, tokens
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

GRANITE = "granite-moe-3b-a800m"


@functools.lru_cache(maxsize=None)
def _case(name):
    """(reference config, port config, JAX params, port params): the
    port's init carried across as numpy, with ``tests/torch_jamba.py``'s
    perturbations (norm scales drawn, routers and mamba projections
    scaled up); jamba's smoke block (``jamba-8``) or its first 4 layers
    (``jamba-4``), granite's smoke variant at two blocks."""
    if name == GRANITE:
        jcfg = jsmoke(jget_config(GRANITE), n_blocks=2)
        cfg = smoke_variant(get_config(GRANITE), n_blocks=2)
    else:
        layers = int(name.split("-")[-1])
        jcfg = jcut(jsmoke(jget_config(ARCH)), layers)
        cfg = cut_depth(smoke_variant(get_config(ARCH)), layers)
    npp = perturbed(bridge.params_to_numpy(
        T.init_model(cfg, seed=0, device="cpu"), cfg), seed=1)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, npp),
            bridge.params_from_jax(npp, cfg, device="cpu"))


def _key(path):
    """A reference key path as a ``LeafGroups`` path."""
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _port_grads(tp, cfg, loss_of):
    """(value, metrics, gradients in the reference's layout, numpy): a
    leaf the value does not reach gets zeros."""
    tparams = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    leaves = tree_leaves(tparams)
    value, metrics = loss_of(tparams)
    grads = iter(torch.autograd.grad(value, leaves, allow_unused=True))
    grads = tree_map(lambda t: (lambda g: torch.zeros_like(t) if g is None
                                else g)(next(grads)), tparams)
    return value, metrics, bridge.params_to_numpy(grads, cfg)


# ---------------------------------------------------------------------------
# the router's aux loss and the loss's gradients
# ---------------------------------------------------------------------------

# each case's loss, the recompute on in the reference as in the training
# step: (its expert path, the aux coefficient; None is the config's
# 0.01).  The smoke block takes the training step's own loss (tcfg's
# defaults: the capacity path, 0.01), whose gradient the step test
# reuses; the 4-layer cut and granite take the dense path with the aux
# at 1.0, as large a term as the cross-entropy.
CASES = {"jamba-8": ("a2a", None), "jamba-4": ("dense", 1.0),
         GRANITE: ("dense", 1.0)}
TOKENS = (2, 25)
# f32 gradients: rtol 1e-4 and an absolute part of JAMBA_GRAD_ATOL of the
# leaf's largest element (summation order only).  Readings on the CPU,
# the largest |port - reference| / max|reference| of any leaf: 7.1e-6
# (the smoke block: layer 6's dt_bias, through 7 mamba layers whose
# projections the perturbation scales up), 3.7e-6 (the 4-layer cut),
# 1.0e-6 (granite; the MoE tests hold it at 1e-6 with the aux at 0.01)
JAMBA_GRAD_ATOL = 3e-5


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=F32_GRAD_RTOL,
        atol=JAMBA_GRAD_ATOL * float(np.abs(want).max()), err_msg=what)


def _loss_kw(case):
    moe_impl, coef = CASES[case]
    return dict(moe_impl=moe_impl, aux_coef=coef)


@functools.lru_cache(maxsize=None)
def _reference_loss(case):
    """The reference's jitted ``jax.value_and_grad`` of ``lm_train_loss``
    over TOKENS: (tokens, ((loss, metrics), gradients))."""
    jcfg, cfg, jp, _ = _case(case)
    toks = tokens(cfg, TOKENS, 71)
    out = jax.jit(jax.value_and_grad(
        lambda p, t: japi.lm_train_loss(p, {"tokens": t}, jcfg, JPOL,
                                        remat=True, **_loss_kw(case)),
        has_aux=True))(jp, jnp.asarray(toks))
    return toks, out


def check_loss_and_gradients(case, remat):
    """``lm_train_loss`` of ``case`` against ``jax.grad`` of the
    reference's, the port's recompute off or on: the loss, lm_loss and
    router_aux -- the reference's, each block's last pattern position's
    aux (jamba's position 7; 3 in the 4-layer cut), which a sum over
    every MoE layer misses -- and every gradient leaf: the routers at
    every position (at 1, 3 and 5 the aux reaches them only through the
    activations), the experts and the 9 mamba leaves of each mamba layer
    included."""
    _, cfg, _, tp = _case(case)
    toks, ((jloss, jm), jgrads) = _reference_loss(case)
    loss, m, grads = _port_grads(tp, cfg, lambda p: api.lm_train_loss(
        p, {"tokens": torch.from_numpy(toks)}, cfg, POL, remat=remat,
        **_loss_kw(case)))
    for k, got, want in (("loss", loss.detach(), jloss),
                         ("lm_loss", m["lm_loss"], jm["lm_loss"]),
                         ("router_aux", m["router_aux"], jm["router_aux"])):
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL,
                                   err_msg=k)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert len(jflat) == len(tflat)
    names = {_key(p)[-1] for p, _ in jflat}
    assert "router" in names
    if case != GRANITE:
        assert {"a_log", "dt_bias", "conv_w", "in_proj"} <= names
    for path, want in jflat:
        _close(tflat[path], want, jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat", [False, True])
def test_router_aux_and_every_gradient_match_the_reference(remat):
    """The smoke block: ``check_loss_and_gradients``."""
    check_loss_and_gradients("jamba-8", remat)


@pytest.mark.parametrize("optimizer", ["lamb", "adamw"])
def test_train_step_matches_the_reference(optimizer):
    """One f32 step of the port's ``train_step_fn`` (the smoke block,
    TOKENS in one micro-batch, the recompute on, the capacity path) from
    the reference's weights against the reference's step taken through
    its own functions: its jitted gradient of the same loss, then its
    ``_clip_grads`` and ``_optimizer_update`` (``train_step_fn``'s tail
    at accumulation 1 in f32: no loss scale).  The scalars, and every
    group's master and moments, the mamba leaves of each position
    included (LAMB's trust ratio and decay on them as on every leaf: the
    reference has no decay mask), at tests/test_torch_moe_train.py's
    tolerances."""
    jcfg, cfg, jp, tp = _case("jamba-8")
    kw = dict(precision="f32", accum_steps=1, optimizer=optimizer,
              learning_rate=2e-3, warmup_steps=1, total_steps=3)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    assert (tcfg.moe_impl, tcfg.remat) == ("a2a", True)
    toks, ((jloss, jm), jgrads) = _reference_loss("jamba-8")

    def update(grads, opt):
        grads, gnorm = jts._clip_grads(grads, jtcfg.grad_clip)
        opt, lr = jts._optimizer_update(grads, opt, jtcfg,
                                        skip_update=False)
        return opt, gnorm, lr
    jopt, jnorm, jlr = jax.jit(update)(
        jgrads, jts.init_train_state(jp, JPOL, jtcfg).opt)
    state = ts.init_train_state(tp, POL, tcfg, cfg=cfg)
    start = {state.opt.groups.name(p): t.clone() for p, t in
             state.opt.groups.stacked(state.opt.master).items()}
    state, m = ts.train_step_fn(state, api.to_device({"tokens": toks},
                                                     "cpu"),
                                cfg=cfg, tcfg=tcfg, policy=POL)
    assert state.opt.step == int(jopt.step) == 1 and not m["skipped"]
    for k, want in (("loss", jloss), ("grad_norm", jnorm), ("lr", jlr),
                    ("lm_loss", jm["lm_loss"]),
                    ("router_aux", jm["router_aux"])):
        np.testing.assert_allclose(float(m[k]), float(want), **SCALAR_TOL,
                                   err_msg=k)
    # the clipped gradient, from the first moment
    grad = {"/".join(_key(p)): np.asarray(x) / (1 - 0.9) for p, x in
            jax.tree_util.tree_flatten_with_path(jopt.m)[0]}
    for name, tol in (("master", MASTER_TOL), ("m", MOMENT_TOL),
                      ("v", MOMENT_TOL)):
        got = {state.opt.groups.name(p): t for p, t in
               state.opt.groups.stacked(getattr(state.opt, name)).items()}
        want = jax.tree_util.tree_flatten_with_path(getattr(jopt, name))[0]
        assert len(got) == len(want)
        for path, w in want:
            key = "/".join(_key(path))
            g, w = got[key].numpy(), np.asarray(w)
            msg = f"{name} {key}"
            well = np.abs(grad[key]) >= ADAMW_WELL
            if optimizer == "lamb":
                # an element whose clipped gradient lies under ADAMW_WELL
                # takes m / (sqrt(v) + 1e-6), about g / (|g| + 1e-6), from
                # the gradient's last digits (one of embed/tok's 131072)
                if name == "master":
                    g, w = g[well], w[well]
                np.testing.assert_allclose(g, w, **tol, err_msg=msg)
                continue
            if name == "master":
                s0 = start[key].numpy()
                g, w = (g - s0)[well], (w - s0)[well]
            bound = (ADAMW_UPDATE_REL_L2 if name == "master"
                     else ADAMW_MOMENT_REL_L2)
            assert np.linalg.norm(g - w) <= bound * np.linalg.norm(w), \
                (msg, np.linalg.norm(g - w) / np.linalg.norm(w))


# ---------------------------------------------------------------------------
# the groups and checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stepped():
    """(the port's state after one f32 AdamW step, the reference's
    ``TrainState`` holding the same numbers in its layout, the
    TrainConfig)."""
    jcfg, cfg, jp, tp = _case("jamba-8")
    kw = dict(precision="f32", accum_steps=1, optimizer="adamw",
              warmup_steps=1, total_steps=4)
    tcfg = TrainConfig(**kw)
    state = ts.init_train_state(tp, POL, tcfg, cfg=cfg)
    state, _ = ts.train_step_fn(
        state, api.to_device({"tokens": tokens(cfg, (2, 17), 73)}, "cpu"),
        cfg=cfg, tcfg=tcfg, policy=POL)
    jstate = jts.init_train_state(jp, JPOL, JTrainConfig(**kw))
    ref = {n: bridge.params_to_numpy(
        state.opt.groups.tree(getattr(state.opt, n)), cfg)
        for n in ("master", "m", "v")}
    ls = state.loss_scale
    jstate = jstate._replace(
        opt=jstate.opt._replace(step=np.int32(state.opt.step), **ref),
        loss_scale=jamp.LossScaleState(np.float32(ls.scale),
                                       np.int32(ls.good_steps),
                                       np.int32(ls.total_skipped)))
    return jstate, state, tcfg


def test_leaf_groups_match_the_reference_stacked_tree(stepped):
    """The state's groups are the reference's stacked leaves: one a leaf
    name and block-pattern position, named ``blocks/<position>/...``; the
    mamba leaves of positions 1..7 (1, 2 in layers of one block)."""
    jstate, state, _ = stepped
    groups = state.opt.groups
    stacked = groups.stacked(state.opt.master)
    want = {"/".join(_key(path)): tuple(np.shape(x)) for path, x in
            jax.tree_util.tree_flatten_with_path(jstate.opt.master)[0]}
    got = {groups.name(p): tuple(stacked[p].shape) for p in groups.paths}
    assert got == want
    cfg = _case("jamba-8")[1]
    din, n = cfg.mamba_d_inner, cfg.mamba_d_state
    assert got["blocks/2/mixer/a_log"] == (1, din, n)
    assert got["blocks/2/mixer/in_proj"] == (1, cfg.d_model, 2 * din)
    assert "blocks/0/mixer/a_log" not in got


@pytest.mark.parametrize("way", ["port_to_reference", "reference_to_port"])
def test_checkpoints_interchange_both_ways(stepped, tmp_path, way):
    """A checkpoint of the hybrid's state written by one package restores
    into the other bit for bit, with the reference's manifest: names,
    shapes, dtypes and, for the same numbers, the same checksums."""
    jstate, state, tcfg = stepped
    cfg = _case("jamba-8")[1]
    if way == "port_to_reference":
        save_checkpoint(str(tmp_path), 1, state)
        got, step = jckpt.restore_checkpoint(str(tmp_path), like=jstate)
        assert step == 1 and int(got.opt.step) == 1
        names = load_manifest(str(tmp_path), 1)["names"]
        assert "opt/master/blocks/3/mixer/a_log" in names
        for n in ("master", "m", "v"):
            stacked = {state.opt.groups.name(p): t for p, t in
                       state.opt.groups.stacked(
                           getattr(state.opt, n)).items()}
            for path, w in jax.tree_util.tree_flatten_with_path(
                    getattr(got.opt, n))[0]:
                assert stacked["/".join(_key(path))].numpy().tobytes() == \
                    np.asarray(w).tobytes(), (n, path)
        return
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, jstate)
    fresh = ts.init_train_state(api.init_params(cfg, seed=7, device="cpu"),
                                POL, tcfg, cfg=cfg)
    back, step = restore_checkpoint(str(tmp_path / "ref"), fresh)
    assert back is fresh and step == 1 and back.opt.step == 1
    save_checkpoint(str(tmp_path / "port"), 1, back)
    rm = load_manifest(str(tmp_path / "ref"), 1)
    pm = load_manifest(str(tmp_path / "port"), 1)
    for key in ("names", "shapes", "dtypes", "checksums"):
        assert pm[key] == rm[key], key
