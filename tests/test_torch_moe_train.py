"""One training step of the MoE decoders (granite-moe-3b-a800m,
qwen3-moe-30b-a3b) against the JAX package's jitted step, at
``smoke_variant`` sizes (two blocks, 4 experts top-2) on
``tests/test_torch_moe_serve.py``'s perturbed weights: accumulation 2,
the recompute on, the capacity path (the reference's default
``moe_impl="a2a"``, which without a mesh is ``_moe_single``).  In f32,
under LAMB and AdamW, the loss, lm_loss, router_aux, gradient norm and
learning rate, and every group's master and moments, the router and the
expert leaves included, at ``tests/test_torch_variants_step.py``'s
tolerances; in bf16 the scalars, the step taken and every group's
gradient (the gradient does not depend on the optimizer: LAMB's step).

The gradients themselves are held in ``tests/test_torch_moe_grad.py``;
the groups, checkpoints, the twins of the reference's MoE training tests
and the CLI in ``tests/test_torch_moe_state.py``."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.amp import make_policy as jmake_policy
from repro.train import train_step as jts
from repro_torch.configs import TrainConfig
from repro_torch.core.amp import make_policy
from repro_torch.models import api
from repro_torch.train import train_step as ts
from test_torch_moe_serve import ARCHS, _model, _tokens
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

MASTER_TOL = dict(rtol=1e-5, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-8)
SCALAR_TOL = dict(rtol=1e-5, atol=1e-7)
ADAMW_UPDATE_REL_L2 = 1e-3
ADAMW_MOMENT_REL_L2 = 2e-4
ADAMW_WELL = 1e-6
# bf16: the packages round at other places (XLA's CPU dots and fusions
# against PyTorch's), and a token whose k-th and (k+1)-th router
# probabilities lie within that rounding picks another expert in each
# (tests/test_torch_moe_forward.py prints the share of identical
# choices); on the capacity path the flip also moves which assignments
# keep a slot.  A flip moves its experts' gradients, and through the
# backward every group's, by far more than rounding does, and LAMB's and
# AdamW's first steps are sign-like.  So the bf16 step is held as
# tests/test_torch_train.py holds its f16 step: by its scalars, the step
# taken, and each group's gradient (from the first moment) within
# BF16_GRAD_REL_L2.  Readings on the CPU: loss 4.1e-5 (granite) and
# 3.4e-4 (qwen3) relative, gradient norm <= 3.8e-4; gradient groups
# 4.9e-3 to 1.4e-2 (granite) and 2.8e-2 to 2.1e-1 (qwen3: its router;
# its experts ~0.1).
BF16_SCALAR_RTOL = 2e-3
BF16_GRAD_REL_L2 = 0.3


def _key(path):
    """A reference key path as a ``LeafGroups`` path (one block-pattern
    position: the position dropped)."""
    return tuple(k.key for k in path if hasattr(k, "key"))


@pytest.mark.parametrize("optimizer,precision", [
    ("lamb", "f32"), ("adamw", "f32"), ("lamb", "bf16")])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, optimizer, precision):
    """One step of each package's ``train_step_fn`` (2 x 24 tokens in two
    micro-batches, the recompute on, the capacity path) from the same
    weights."""
    jcfg, cfg, jp, tp = _model(arch, 2)
    kw = dict(precision=precision, accum_steps=2, optimizer=optimizer,
              learning_rate=2e-3, warmup_steps=1, total_steps=3)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jpol, pol = jmake_policy(precision), make_policy(precision)
    jstate = jts.init_train_state(jp, jpol, jtcfg)
    state = ts.init_train_state(tp, pol, tcfg, cfg=cfg)
    start = {p: t.clone() for p, t in
             state.opt.groups.stacked(state.opt.master).items()}
    tokens = _tokens(cfg, (2, 25), 21)
    jstate, jm = jax.jit(partial(jts.train_step_fn, cfg=jcfg, tcfg=jtcfg,
                                 policy=jpol))(
        jstate, {"tokens": jnp.asarray(tokens)})
    state, m = ts.train_step_fn(state, api.to_device({"tokens": tokens},
                                                     "cpu"),
                                cfg=cfg, tcfg=tcfg, policy=pol)
    assert state.opt.step == int(jstate.opt.step) == 1
    assert not m["skipped"] and not bool(jm["skipped"])
    assert float(m["loss_scale"]) == float(jm["loss_scale"])
    tol = SCALAR_TOL if precision == "f32" else dict(rtol=BF16_SCALAR_RTOL)
    for k in ("loss", "grad_norm", "lr", "lm_loss", "router_aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **tol,
                                   err_msg=k)
    grad = {_key(p): np.asarray(x) / (1 - 0.9) for p, x in
            jax.tree_util.tree_flatten_with_path(jstate.opt.m)[0]}
    if precision == "bf16":
        got = state.opt.groups.stacked(state.opt.m)
        assert len(got) == len(grad)
        for key, want in grad.items():
            rel = np.linalg.norm(got[key].numpy() / (1 - 0.9) - want) / \
                np.linalg.norm(want)
            assert rel <= BF16_GRAD_REL_L2, (key, rel)
        return
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
