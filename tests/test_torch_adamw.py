"""AdamW (``repro_torch.optim.adamw``) against ``repro.optim.adamw`` on the
same state and gradients, over several steps with a skipped one; three
steps of each package's ``train_step_fn`` on the smoke deepseek-7b with
AdamW and with LAMB at accumulation 1 and 2 (master, moments, step, loss,
gradient norm and learning rate after each step, f32); and the decoder's
``TrainState`` checkpoints interchanged with the reference's both ways,
the next step matching."""
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
from repro.optim import adamw_update as jadamw_update
from repro.optim import lamb_init as jlamb_init
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.core import amp
from repro_torch.models import api
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.train import train_step as ts
from repro_torch.train.checkpoint import (load_manifest, restore_checkpoint,
                                          save_checkpoint)

JCFG = jsmoke(jget_config("deepseek-7b"), n_blocks=2)
CFG = smoke_variant(get_config("deepseek-7b"), n_blocks=2)
# after each optimizer step, as tests/test_torch_train.py holds LAMB
MASTER_TOL = dict(rtol=1e-5, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-8)
SCALAR_TOL = dict(rtol=1e-5, atol=1e-7)
# AdamW's first steps divide each gradient element by its own magnitude
# (m / (sqrt(v) + 1e-8) = g / (|g| + 1e-8) at step 1), so where |g| sits
# near 1e-8 the packages' rounding-level gradient differences (~1e-10)
# move the update by up to ~10 % of lr: 70 of ~500 k master elements fall
# outside MASTER_TOL at step 1 (by up to 8.8e-5 at lr 1e-3), and the
# moments of the next steps follow.  So in the train step AdamW is held
# per group by the relative L2 difference of the update since the start
# (worst reading 2.2e-4) and of each moment (3.7e-5); AdamW alone, on the
# same inputs, is held elementwise (ADAMW_TOL).
ADAMW_UPDATE_REL_L2 = 1e-3
ADAMW_MOMENT_REL_L2 = 2e-4


def _params(seed=0):
    jp, _ = japi.init_params(jax.random.PRNGKey(seed), JCFG)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _tokens(seed, b, s):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


def _keys(path):
    """A reference key path as a ``LeafGroups`` path (the block_pattern
    position dropped)."""
    return tuple(k.key for k in path if hasattr(k, "key"))


@pytest.mark.parametrize("optimizer,accum", [
    pytest.param("adamw", 1, id="adamw-1"),
    pytest.param("adamw", 2, id="adamw-2"),
    pytest.param("lamb", 1, id="lamb-1"),
    pytest.param("lamb", 2, id="lamb-2")])
def test_three_steps_match_the_reference_train_step(optimizer, accum):
    """The reference's ``train_step_fn`` (jitted) and the port's, from the
    same weights on the same LM batches (4 x 65 tokens), warmup 2 over 3
    steps in f32."""
    jparams, np_params = _params()
    kw = dict(precision="f32", accum_steps=accum, optimizer=optimizer,
              learning_rate=2e-3, warmup_steps=2, total_steps=3)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jpol, pol = jamp.make_policy("f32"), amp.make_policy("f32")
    jstate = jts.init_train_state(jparams, jpol, jtcfg)
    state = ts.init_train_state(
        bridge.params_from_jax(np_params, CFG, device="cpu"), pol, tcfg,
        cfg=CFG)
    jstep = jax.jit(partial(jts.train_step_fn, cfg=JCFG, tcfg=jtcfg,
                            policy=jpol))
    start = {p: t.clone() for p, t in
             state.opt.groups.stacked(state.opt.master).items()}
    for step in range(1, 4):
        batch = {"tokens": _tokens(100 + step, 4, 65)}
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        state, m = ts.train_step_fn(state, api.to_device(batch, "cpu"),
                                    cfg=CFG, tcfg=tcfg, policy=pol)
        assert state.opt.step == int(jstate.opt.step) == step
        for k in ("loss", "grad_norm", "lr", "lm_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       **SCALAR_TOL, err_msg=f"{step} {k}")
        assert not m["skipped"] and not bool(jm["skipped"])
        for name, tol in (("master", MASTER_TOL), ("m", MOMENT_TOL),
                          ("v", MOMENT_TOL)):
            got = state.opt.groups.stacked(getattr(state.opt, name))
            want = jax.tree_util.tree_flatten_with_path(
                getattr(jstate.opt, name))[0]
            assert len(got) == len(want) == 12
            for path, w in want:
                key = _keys(path)
                g, w = got[key].numpy(), np.asarray(w)
                msg = f"step {step} {name} {key}"
                if optimizer == "lamb":
                    np.testing.assert_allclose(g, w, **tol, err_msg=msg)
                    continue
                if name == "master":
                    g, w = g - start[key].numpy(), w - start[key].numpy()
                bound = (ADAMW_UPDATE_REL_L2 if name == "master"
                         else ADAMW_MOMENT_REL_L2)
                assert np.linalg.norm(g - w) <= bound * np.linalg.norm(w), \
                    (msg, np.linalg.norm(g - w) / np.linalg.norm(w))




def _random_state(rng, like):
    """Numpy master, m, v trees shaped as ``like``: master of std 0.02,
    moments away from 0."""
    master = jax.tree_util.tree_map(
        lambda x: (0.02 * rng.standard_normal(x.shape)).astype(np.float32),
        like)
    m = jax.tree_util.tree_map(
        lambda x: (1e-3 * rng.standard_normal(x.shape)).astype(np.float32),
        like)
    v = jax.tree_util.tree_map(
        lambda x: (1e-6 * rng.random(x.shape)).astype(np.float32), like)
    return master, m, v


def _grads(rng, like):
    """Gradients whose magnitudes span 1e-10 .. 1, so the eps (1e-8) and
    the bias corrections both matter."""
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 10.0 ** rng.uniform(
            -10, 0, x.shape)).astype(np.float32), like)


def _flat(groups, tree):
    return groups.flatten(bridge.params_from_jax(tree, CFG, device="cpu"))


# AdamW alone on the same inputs: the packages differ by the rounding of
# XLA's fused elementwise ops against PyTorch's one op at a time, an ulp
# here and there.  Readings on the CPU over the test's six updates: master
# within 2.4e-7 absolute (an ulp of the unit weights; 6.3e-4 relative only
# near 0), m within 3.0e-8 absolute (0.3 relative where b1 * m and
# (1 - b1) * g nearly cancel), v within 4.5e-7 relative.
ADAMW_TOL = dict(rtol=1e-6, atol=1e-7)


def test_adamw_update_matches_the_reference_over_steps_with_a_skip():
    """Six updates at changing learning rates from ``adamw_init`` (unit
    weights, zero moments, step 0), gradients spanning 1e-10 .. 1, so
    that the eps (1e-8), the float32 bias corrections and the weight
    decay all show; update 4 is skipped (``skip_update``), which leaves
    master, moments and step untouched, bit for bit, in both packages.
    After every update master, m, v and the step agree (ADAMW_TOL)."""
    rng = np.random.default_rng(0)
    _, np_params = _params()
    master = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), np_params)
    jstate = jlamb_init(jax.tree_util.tree_map(jnp.asarray, master))
    state = adamw_init(bridge.params_from_jax(master, CFG, device="cpu"))
    groups = state.groups
    jupdate = jax.jit(jadamw_update)
    for i, lr in enumerate((1e-3, 2e-3, 5e-4, 3e-3, 1e-4, 2e-3)):
        grads = _grads(rng, np_params)
        skip = i == 3
        before = {k: {p: t.clone() for p, t in getattr(state, k).items()}
                  for k in ("master", "m", "v")}
        jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, grads), jstate,
                         lr=jnp.float32(lr), skip_update=jnp.bool_(skip))
        state = adamw_update(_flat(groups, grads), state, lr=lr,
                             skip_update=skip)
        assert state.step == int(jstate.step) == i + (i < 3)
        if skip:
            for k, saved in before.items():
                for p, t in saved.items():
                    assert torch.equal(getattr(state, k)[p], t), (k, p)
        for name in ("master", "m", "v"):
            got = groups.stacked(getattr(state, name))
            for path, w in jax.tree_util.tree_flatten_with_path(
                    getattr(jstate, name))[0]:
                np.testing.assert_allclose(
                    got[_keys(path)].numpy(), np.asarray(w), **ADAMW_TOL,
                    err_msg=f"update {i + 1} {name} {_keys(path)}")


# ---------------------------------------------------------------------------
# The decoder's checkpoints, interchanged with the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_state():
    """The reference's decoder ``TrainState`` with moments, step and loss
    scale away from their initial values (numpy leaves), the port's state
    bridged from the same numbers, and an AdamW ``TrainConfig``."""
    _, np_params = _params()
    master, m, v = _random_state(np.random.default_rng(1), np_params)
    jstate = jts.init_train_state(jax.tree_util.tree_map(jnp.asarray, master),
                                  jamp.make_policy("f32"), JTrainConfig())
    jstate = jstate._replace(
        opt=jstate.opt._replace(step=np.int32(7), master=master, m=m, v=v),
        loss_scale=jamp.LossScaleState(np.float32(2.0 ** 13), np.int32(5),
                                       np.int32(2)))
    tcfg = TrainConfig(precision="f32", accum_steps=1, optimizer="adamw",
                       warmup_steps=2, total_steps=20)
    state = _bridged(jstate, tcfg)
    return jstate, state, tcfg


def _bridged(jstate, tcfg):
    state = ts.init_train_state(
        bridge.params_from_jax(jstate.opt.master, CFG, device="cpu"),
        amp.make_policy("f32"), tcfg, cfg=CFG)
    groups = state.opt.groups
    state.opt.m = _flat(groups, jstate.opt.m)
    state.opt.v = _flat(groups, jstate.opt.v)
    state.opt.step = int(jstate.opt.step)
    ls = jstate.loss_scale
    state.loss_scale = amp.LossScaleState(float(ls.scale),
                                          int(ls.good_steps),
                                          int(ls.total_skipped))
    return state


def _other_state(tcfg):
    params = api.init_params(CFG, seed=5, device="cpu")
    return ts.init_train_state(params, amp.make_policy("f32"), tcfg,
                               cfg=CFG)


def _step(state, tcfg, seed=9):
    batch = api.to_device({"tokens": _tokens(seed, 2, 65)}, "cpu")
    return ts.train_step_fn(state, batch, cfg=CFG, tcfg=tcfg,
                            policy=amp.make_policy("f32"))


def test_port_restores_a_reference_decoder_checkpoint_and_steps_on(
        tmp_path, ref_state):
    """The reference's checkpoint of a decoder state (``blocks/0/...``
    leaves: one stacked dict per block_pattern position) restores into the
    port bit for bit, and the next AdamW step from it equals, bit for bit,
    the step from the state bridged from the same numbers."""
    jstate, _, tcfg = ref_state
    jckpt.save_checkpoint(str(tmp_path), 7, jstate)
    names = load_manifest(str(tmp_path), 7)["names"]
    assert len(names) == 1 + 3 * 12 + 3
    assert "opt/master/blocks/0/mixer/wq" in names
    state = _other_state(tcfg)
    got, step = restore_checkpoint(str(tmp_path), state)
    assert got is state and step == 7 and state.opt.step == 7
    assert state.loss_scale == amp.LossScaleState(2.0 ** 13, 5, 2)
    for name in ("master", "m", "v"):
        stacked = state.opt.groups.stacked(getattr(state.opt, name))
        for path, w in jax.tree_util.tree_flatten_with_path(
                getattr(jstate.opt, name))[0]:
            assert stacked[_keys(path)].numpy().tobytes() == \
                np.asarray(w).tobytes(), (name, path)
    bridged = _bridged(jstate, tcfg)
    (s1, m1), (s2, m2) = _step(state, tcfg), _step(bridged, tcfg)
    assert float(m1["loss"]) == float(m2["loss"])
    assert s1.opt.step == s2.opt.step == 8
    for name in ("master", "m", "v"):
        for p, t in getattr(s1.opt, name).items():
            assert torch.equal(t, getattr(s2.opt, name)[p]), (name, p)


def test_reference_restores_a_port_decoder_checkpoint_and_steps_on(
        tmp_path, ref_state):
    """The port's checkpoint of the same state has the reference's manifest
    (names, shapes, dtypes, checksums), restores into the reference's
    ``TrainState`` bit for bit, and the reference's next AdamW step from it
    equals its step from its own state, bit for bit."""
    jstate, state, tcfg = ref_state
    port, ref = tmp_path / "port", tmp_path / "ref"
    save_checkpoint(str(port), 7, state)
    jckpt.save_checkpoint(str(ref), 7, jstate)
    pm, rm = load_manifest(str(port), 7), load_manifest(str(ref), 7)
    for key in ("format", "step", "names", "shapes", "dtypes", "checksums"):
        assert pm[key] == rm[key], key
    got, step = jckpt.restore_checkpoint(str(port), like=jstate)
    assert step == 7
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    jtcfg = JTrainConfig(precision="f32", accum_steps=1, optimizer="adamw",
                         warmup_steps=2, total_steps=20)
    jstep = jax.jit(partial(jts.train_step_fn, cfg=JCFG, tcfg=jtcfg,
                            policy=jamp.make_policy("f32")))
    batch = {"tokens": jnp.asarray(_tokens(9, 2, 65))}
    (a, ma), (b, mb) = jstep(got, batch), jstep(jstate, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(jax.tree_util.tree_leaves(a.opt),
                    jax.tree_util.tree_leaves(b.opt)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
