"""The port's training step against ``repro.train.train_step``: the same
weights and batches go through three steps of each package's
``train_step_fn`` (LAMB with fp32 master weights, warmup 2, gradient
accumulation 1 and 2), and after every step the master weights, both
moments, the step count, loss, gradient norm and learning rate agree (at
f32); in the paper's f16 with the dynamic loss scale, the loss, every
gradient group, the loss-scale state and the skip decision agree, also on
a fourth step whose loss scale (2**24) overflows.  The reference's step
runs under ``jax.jit``, as its trainers run it: eagerly, each of its
primitives compiles on first use (25 s on the CPU).
Also the dynamic loss scale, the skip of a non-finite step, the schedule
and the phases."""
import dataclasses
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
from repro.optim import warmup_poly_decay as jwarmup
from repro.train import phases as jphases
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.core import amp
from repro_torch.models import api
from repro_torch.optim import warmup_poly_decay
from repro_torch.train import phases
from repro_torch.train import train_step as ts
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

JCFG = jsmoke(jget_config("bert-large"), d_model=128, n_blocks=2)
CFG = smoke_variant(get_config("bert-large"), d_model=128, n_blocks=2)
# After each step, at f32.  The gradients differ from the reference's by
# the order of sums (~1e-6 relative, tests/test_torch_bert.py); LAMB's
# direction m / sqrt(v) divides such differences by small values, and
# the moment kernel's plain version takes the bias corrections as the
# reference's jnp path does.
MASTER_TOL = dict(rtol=1e-5, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-8)
SCALAR_TOL = dict(rtol=1e-5, atol=1e-7)
# f16: both packages run f16 products and round at different places
# (XLA's CPU dot against PyTorch's), 2**-11 relative each, compounded over
# the layers.  LAMB's first steps are sign-like (m / sqrt(v)), so where a
# gradient sits near 0 the two masters move apart: in f16 the step is held
# by its loss, gradients and loss-scale decision, not by its masters.
# Readings on the CPU: loss 4.7e-6, gradient norm 1.9e-5, worst gradient
# group 9.5e-3 (median 8.2e-4).
F16_SCALAR_TOL = dict(rtol=1e-4, atol=1e-7)
F16_GRAD_REL_L2 = 2e-2


def _batches(n, b=4, s=128):
    rng = np.random.default_rng(11)
    p = api.mlm_positions_count(s)
    out = []
    for _ in range(n):
        labels = rng.integers(5, CFG.vocab_size, (b, p)).astype(np.int32)
        labels[:, p // 2:][rng.random((b, p - p // 2)) < 0.5] = -100
        type_ids = np.zeros((b, s), np.int32)
        type_ids[:, s // 2:] = 1
        out.append({
            "tokens": rng.integers(5, CFG.vocab_size, (b, s)).astype(np.int32),
            "type_ids": type_ids,
            "mlm_positions": np.sort(rng.choice(np.arange(1, s), (b, p)),
                                     axis=1).astype(np.int32),
            "mlm_labels": labels,
            "nsp_labels": rng.integers(0, 2, b).astype(np.int32)})
    return out


def _keys(path):
    return tuple(k.key for k in path)


def _step_and_grads(jts_step):
    """The reference's step, also returning its unscaled gradients: they
    are taken through the ``grad_exchange`` hook, which the step calls with
    them (then the loss-scale, finite check and optimizer run on what the
    hook returns: the same gradients and flag as without it)."""
    def step(state, batch):
        seen = {}

        def exchange(grads, err):
            seen["grads"] = grads
            return grads, err, jamp.all_finite(grads)
        state, metrics = jts_step(state, batch, grad_exchange=exchange)
        return state, metrics, seen["grads"]
    return step


@pytest.mark.parametrize("accum,precision", [
    pytest.param(1, "f32", id="1"), pytest.param(2, "f32", id="2"),
    pytest.param(2, "f16", id="f16-2")])
def test_three_steps_match_the_reference_train_step(accum, precision):
    """Catches the LAMB trust-ratio grouping: the reference stacks each
    block leaf over the layers and takes one ratio per stacked leaf.  With
    a ratio per layer tensor instead, 43 % of the first step's
    ``blocks.attn.wk`` master elements fall outside the tolerance (by up
    to 3.4e-6).  In f16 (the dynamic loss scale at 2**15, then forced to
    2**24 for a fourth step, which both packages must skip): loss and
    gradient norm within F16_SCALAR_TOL, every gradient group within
    F16_GRAD_REL_L2, and the loss-scale state and skip decision equal."""
    jparams = jax.jit(lambda key: japi.init_params(key, JCFG)[0])(
        jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    kw = dict(precision=precision, accum_steps=accum, optimizer="lamb",
              learning_rate=2e-3, warmup_steps=2, total_steps=3)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jpol, pol = jamp.make_policy(precision), amp.make_policy(precision)
    jstate = jts.init_train_state(jparams, jpol, jtcfg)
    state = ts.init_train_state(
        bridge.params_from_jax(np_params, CFG, device="cpu"), pol, tcfg,
        cfg=CFG)
    if precision == "f16":
        _f16_steps(jstate, state, jtcfg, tcfg, jpol, pol)
        return
    jstep = jax.jit(partial(jts.train_step_fn, cfg=JCFG, tcfg=jtcfg,
                            policy=jpol))
    for step, batch in enumerate(_batches(3), 1):
        jstate, jm = jstep(jstate,
                           {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = ts.train_step_fn(state, api.to_device(batch, "cpu"),
                                    cfg=CFG, tcfg=tcfg, policy=pol)
        assert state.opt.step == int(jstate.opt.step) == step
        for k in ("loss", "grad_norm", "lr", "mlm_loss", "nsp_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       **SCALAR_TOL, err_msg=f"{step} {k}")
        assert not m["skipped"] and not bool(jm["skipped"])
        for name, tol in (("master", MASTER_TOL), ("m", MOMENT_TOL),
                          ("v", MOMENT_TOL)):
            got = state.opt.groups.stacked(getattr(state.opt, name))
            want = jax.tree_util.tree_flatten_with_path(
                getattr(jstate.opt, name))[0]
            assert len(got) == len(want) == 26
            for path, w in want:
                np.testing.assert_allclose(
                    got[_keys(path)].numpy(), np.asarray(w), **tol,
                    err_msg=f"step {step} {name} {_keys(path)}")


def _f16_steps(jstate, state, jtcfg, tcfg, jpol, pol):
    jstep = jax.jit(_step_and_grads(partial(
        jts.train_step_fn, cfg=JCFG, tcfg=jtcfg, policy=jpol)))
    for step, batch in enumerate(_batches(4), 1):
        if step == 4:   # an overflow: both must skip and halve the scale
            jstate = jstate._replace(loss_scale=jamp.LossScaleState(
                jnp.float32(2.0 ** 24), jnp.int32(5), jnp.int32(0)))
            state.loss_scale = amp.LossScaleState(2.0 ** 24, 5, 0)
        tbatch = api.to_device(batch, "cpu")
        _, grads, _ = ts.step_gradients(state, tbatch, cfg=CFG, tcfg=tcfg,
                                        policy=pol)
        jstate, jm, jgrads = jstep(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = ts.train_step_fn(state, tbatch, cfg=CFG, tcfg=tcfg,
                                    policy=pol)
        ls, jls = state.loss_scale, jstate.loss_scale
        assert (ls.scale, ls.good_steps, ls.total_skipped) == (
            float(jls.scale), int(jls.good_steps), int(jls.total_skipped))
        assert m["skipped"] == bool(jm["skipped"]) == (step == 4), step
        assert state.opt.step == int(jstate.opt.step) == min(step, 3)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **F16_SCALAR_TOL, err_msg=f"{step} loss")
        if step == 4:
            continue
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), **F16_SCALAR_TOL,
                                   err_msg=f"{step} grad_norm")
        got = state.opt.groups.stacked(grads)
        want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
        assert len(got) == len(want) == 26
        for path, w in want:
            g, w = got[_keys(path)].numpy(), np.asarray(w, np.float64)
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= F16_GRAD_REL_L2, (step, _keys(path), rel)


def test_dynamic_loss_scale_follows_the_reference():
    """Growth after the interval, x2 / x0.5, the clamp at [1, 2**24] and
    the skip count, flag by flag (interval 3 to reach the clamps)."""
    flags = [True] * 7 + [False] * 30 + [True] * 4 + [False, True, True]
    for init in (2.0 ** 23, 4.0):
        jls = jamp.DynamicLossScale(initial_scale=init, growth_interval=3)
        tls = amp.DynamicLossScale(initial_scale=init, growth_interval=3)
        js, ts_ = jls.init(), tls.init()
        for f in flags:
            js, japply = jls.update(js, jnp.asarray(f))
            ts_, apply = tls.update(ts_, f)
            assert (ts_.scale, ts_.good_steps, ts_.total_skipped) == (
                float(js.scale), int(js.good_steps), int(js.total_skipped))
            assert apply == bool(japply)
    d = amp.DynamicLossScale()
    assert (d.initial_scale, d.growth_interval, d.growth_factor,
            d.backoff_factor, d.min_scale, d.max_scale) == (
        2.0 ** 15, 2000, 2.0, 0.5, 1.0, 2.0 ** 24)
    assert isinstance(amp.make_loss_scale(amp.make_policy("bf16")),
                      amp.NoOpLossScale)


def test_a_non_finite_step_is_skipped_and_backs_off_the_scale():
    """The paper's f16 + dynamic loss scale on the CPU: at the largest
    scale the f16 gradients overflow; the step applies nothing (master,
    moments and step bit-identical), halves the scale and counts the
    skip."""
    pol = amp.make_policy("f16")
    tcfg = TrainConfig(precision="f16", accum_steps=1, warmup_steps=2,
                       total_steps=3)
    params = api.init_params(CFG, seed=3, device="cpu")
    state = ts.init_train_state(params, pol, tcfg, cfg=CFG)
    assert state.loss_scale == amp.LossScaleState(2.0 ** 15, 0, 0)
    state.loss_scale = amp.LossScaleState(2.0 ** 24, 5, 0)
    before = {n: {p: t.clone() for p, t in getattr(state.opt, n).items()}
              for n in ("master", "m", "v")}
    state, m = ts.train_step_fn(state, api.to_device(_batches(1)[0], "cpu"),
                                cfg=CFG, tcfg=tcfg, policy=pol)
    assert m["skipped"]
    assert state.opt.step == 0
    assert state.loss_scale == amp.LossScaleState(2.0 ** 23, 0, 1)
    for n, saved in before.items():
        for p, t in saved.items():
            assert torch.equal(getattr(state.opt, n)[p], t), (n, p)


def test_warmup_poly_decay_matches_the_reference():
    for kw in (dict(base_lr=1e-3, warmup_steps=3, total_steps=10),
               dict(base_lr=2e-3, warmup_steps=2, total_steps=4),
               dict(base_lr=2e-3, warmup_steps=2, total_steps=1),
               dict(base_lr=1e-4, warmup_steps=0, total_steps=7, power=2.0,
                    end_lr=1e-5)):
        for step in range(0, 13):
            assert warmup_poly_decay(step, **kw) == \
                float(jwarmup(jnp.int32(step), **kw)), (kw, step)


def test_bert_phases_match_the_reference():
    for total, scale in ((5, 128 / 4096), (120, 16 / 4096), (10, 1.0),
                         (1, 0.5)):
        want = jphases.bert_phases(total, scale_batch=scale)
        got = phases.bert_phases(total, scale_batch=scale)
        assert [dataclasses.astuple(p) for p in got] == \
            [dataclasses.astuple(p) for p in want]
        assert [dataclasses.astuple(p.shape) for p in got] == \
            [dataclasses.astuple(p.shape) for p in want]
    p1, p2 = phases.bert_phases(5, scale_batch=128 / 4096)
    assert (p1.seq_len, p1.n_predictions, p1.global_batch, p1.steps) == \
        (128, 20, 128, 4)
    assert (p2.seq_len, p2.n_predictions, p2.global_batch, p2.steps) == \
        (512, 80, 64, 1)


def test_train_config_refuses_the_later_slices_knobs():
    """The four strategies, ``bucket_bytes``, the compressed exchange, the
    overlapped drain, its calibration-only ``"local"`` strategy and both
    optimizers (LAMB and AdamW) are supported; an unknown optimizer (which
    the reference would run as AdamW), an unknown strategy or
    compression, a bucket size of 0 and ``"local"`` with compression or
    overlap raise ``ValueError``."""
    TrainConfig().check_supported()
    TrainConfig(fsdp=False, pure_dp=True).check_supported()
    for strategy in ("psum", "ring", "hierarchical", "bucketed"):
        for comp in ("none", "fp16", "int8"):
            for overlap in (False, True):
                TrainConfig(collective_strategy=strategy, bucket_bytes=64,
                            grad_compression=comp,
                            overlap_exchange=overlap).check_supported()
    TrainConfig(collective_strategy="local").check_supported()
    TrainConfig(optimizer="adamw").check_supported()
    with pytest.raises(ValueError, match="unknown optimizer 'sgd'"):
        TrainConfig(optimizer="sgd").check_supported()
    for kw in (dict(collective_strategy="allgather"), dict(bucket_bytes=0),
               dict(grad_compression="int4"),
               dict(collective_strategy="local", grad_compression="int8"),
               dict(collective_strategy="local", overlap_exchange=True)):
        with pytest.raises(ValueError):
            TrainConfig(**kw).check_supported()
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        JTrainConfig())
