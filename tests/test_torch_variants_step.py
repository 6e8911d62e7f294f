"""One training step of the dense decoder variants (gemma2-27b,
qwen1.5-32b, deepseek-coder-33b) against the JAX package at f32, under
LAMB and under AdamW, at S 640 (the port's flash pair behind the GQA
expansion, the plain versions on the CPU; gemma2's window of 16 masks;
the S 64 route, ``naive_attention``, is held through the gradients in
``tests/test_torch_variants_train.py``, and the optimizers do not see the
route): the same weights and tokens as that file (its helpers),
accumulation 2, the recompute on; the loss, gradient norm,
learning rate and every group's master and moments, grouped per
block-pattern position as the reference stacks them."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import TrainConfig as JTrainConfig
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.configs import TrainConfig
from repro_torch.models import api
from repro_torch.train import train_step as ts
from test_torch_variants_train import (ARCHS, JPOL, POL, _cfgs, _key,
                                       _params, _tokens)
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

S = 640

# after one optimizer step, as tests/test_torch_adamw.py holds the
# deepseek-7b step: LAMB elementwise; AdamW's first step divides each
# gradient element by its own magnitude (g / (|g| + 1e-8)), so it is held
# per group by the relative L2 difference of the update and of each
# moment.  Its update is held where |g| >= ADAMW_WELL (100x its eps):
# below, the packages' ~1e-10 gradient differences move an element's
# update by a large share of lr.  qwen's key bias has such elements by
# nature: with RoPE at theta 1e6 its slow channels barely turn over 64
# positions, and softmax ignores a bias that adds the same score to every
# key (10 % of its gradient below 6e-9; its whole-group update differs by
# 2.9e-3 relative L2 at S 640).  The held elements read within 5e-6
# relative L2 in every group of the three models.
MASTER_TOL = dict(rtol=1e-5, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-8)
SCALAR_TOL = dict(rtol=1e-5, atol=1e-7)
ADAMW_UPDATE_REL_L2 = 1e-3
ADAMW_MOMENT_REL_L2 = 2e-4
ADAMW_WELL = 1e-6

@pytest.mark.parametrize("optimizer", ["lamb", "adamw"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, optimizer):
    """One step of each package's ``train_step_fn`` (2 x S tokens in two
    micro-batches, the recompute on) from the same weights: the loss,
    gradient norm and learning rate, and every group's master and
    moments, grouped per block-pattern position as the reference stacks
    them (gemma2: local and global apart)."""
    jcfg, cfg = _cfgs(arch)
    jp, np_params = _params(arch)
    kw = dict(precision="f32", accum_steps=2, optimizer=optimizer,
              learning_rate=2e-3, warmup_steps=1, total_steps=3)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    npos = len(cfg.block_pattern)
    jstate = jts.init_train_state(jp, JPOL, jtcfg)
    state = ts.init_train_state(
        bridge.params_from_jax(np_params, cfg, device="cpu"), POL, tcfg,
        cfg=cfg)
    start = {p: t.clone() for p, t in
             state.opt.groups.stacked(state.opt.master).items()}
    tokens = _tokens(cfg, 100 + S, 2, S + 1)
    jstate, jm = jax.jit(partial(jts.train_step_fn, cfg=jcfg, tcfg=jtcfg,
                                 policy=JPOL))(
        jstate, {"tokens": jnp.asarray(tokens)})
    state, m = ts.train_step_fn(state, api.to_device({"tokens": tokens},
                                                     "cpu"),
                                cfg=cfg, tcfg=tcfg, policy=POL)
    assert state.opt.step == int(jstate.opt.step) == 1
    assert not m["skipped"] and not bool(jm["skipped"])
    for k in ("loss", "grad_norm", "lr", "lm_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **SCALAR_TOL,
                                   err_msg=k)
    # the gradient AdamW took, from its first moment (b1 0.9)
    grad = {_key(p, npos): np.asarray(m) / (1 - 0.9) for p, m in
            jax.tree_util.tree_flatten_with_path(jstate.opt.m)[0]}
    for name, tol in (("master", MASTER_TOL), ("m", MOMENT_TOL),
                      ("v", MOMENT_TOL)):
        got = state.opt.groups.stacked(getattr(state.opt, name))
        want = jax.tree_util.tree_flatten_with_path(
            getattr(jstate.opt, name))[0]
        assert len(got) == len(want)
        for path, w in want:
            key = _key(path, npos)
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
