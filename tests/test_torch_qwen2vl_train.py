"""Training qwen2-vl-7b on the port against the JAX package, at
``smoke_variant`` sizes (``tests/torch_qwen2vl.py``: 2 layers, 8 vision
tokens, perturbed weights carried across by ``bridge``), in f32:

* ``lm_train_loss`` with the batch's vision embeddings, the port's
  recompute off and on, against ``jax.grad`` of the reference's (its
  recompute on): the loss and every gradient, the QKV biases and the
  untied head included;
* one LAMB step against the reference's update, taken through its own
  ``_clip_grads`` and ``_optimizer_update`` on its gradient, at
  ``tests/test_torch_moe_train.py``'s tolerances;
* the batch schema and synthetic batches with ``vision``, the trainer's
  vision stream (the reference's draw, the same every step and across a
  resume), and the training CLI on the CPU: its steps finite, and a run
  crashed and resumed in the uninterrupted run's bits."""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SRC
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import api as japi
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.configs import TrainConfig
from repro_torch.configs.base import InputShape
from repro_torch.launch import train as train_cli
from repro_torch.models import api
from repro_torch.train import train_step as ts
from repro_torch.train.checkpoint import latest_step
from repro_torch.utils import tree_leaves, tree_map
from test_torch_moe_grad import F32_GRAD_RTOL, LOSS_TOL
from test_torch_moe_train import MASTER_TOL, MOMENT_TOL, SCALAR_TOL
from test_torch_train_cli import _finish, _loss_log
from torch_qwen2vl import ARCH, JPOL, POL, model, tokens, vision
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

# f32 gradients: rtol F32_GRAD_RTOL and an absolute part of GRAD_ATOL of
# the leaf's largest element (summation order only)
GRAD_ATOL = 1e-5
TOKENS = (2, 17)
# LAMB's first step is m / sqrt(v) = g / |g| per element: where the
# reference's gradient is this small against its leaf's largest, the sign
# of the update is summation order's, so the master is compared elsewhere
LAMB_WELL = 1e-6


def _key(path):
    """A reference key path as a ``LeafGroups`` path."""
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _batch(cfg, seed=81):
    return {"tokens": tokens(cfg, TOKENS, seed),
            "vision": vision(cfg, TOKENS[0], seed + 1)}


@functools.lru_cache(maxsize=None)
def _reference_loss():
    """The reference's jitted ``jax.value_and_grad`` of ``lm_train_loss``
    (its recompute on) over ``_batch``: (batch, ((loss, metrics),
    gradients))."""
    jcfg, cfg, jp, _ = model()
    batch = _batch(cfg)
    out = jax.jit(jax.value_and_grad(
        lambda p, b: japi.lm_train_loss(p, b, jcfg, JPOL, remat=True),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, out


def _like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) laid out as ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_the_reference(remat):
    """The loss, lm_loss and every gradient leaf of ``lm_train_loss`` from
    tokens and vision embeddings (the labels the next tokens at every
    position, the overwritten ones included): each layer's attention with
    its QKV biases, its MLP and norms, the token table (no gradient
    through the overwritten positions' tokens) and the untied head; the
    port's recompute off and on."""
    _, cfg, _, tp = model()
    batch, ((jloss, jm), jgrads) = _reference_loss()
    tparams = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    loss, m = api.lm_train_loss(tparams, api.to_device(batch, "cpu"), cfg,
                                POL, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(tparams))
    grads = bridge.params_to_numpy(_like(tparams, grads), cfg)
    for k, got, want in (("loss", loss.detach(), jloss),
                         ("lm_loss", m["lm_loss"], jm["lm_loss"])):
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL,
                                   err_msg=k)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert len(jflat) == len(tflat)
    names = {"/".join(_key(p)) for p, _ in jflat}
    assert {"lm_head", "embed/tok", "blocks/0/mixer/bq",
            "blocks/0/mixer/bv"} <= names
    for path, want in jflat:
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(
            tflat[path], want, rtol=F32_GRAD_RTOL,
            atol=GRAD_ATOL * float(np.abs(want).max()),
            err_msg=jax.tree_util.keystr(path))


def test_lamb_step_matches_the_reference():
    """One f32 LAMB step of the port's ``train_step_fn`` (TOKENS with
    their vision embeddings in one micro-batch, the recompute on) from the
    reference's weights against the reference's step through its own
    functions: its jitted gradient of the same loss, then its
    ``_clip_grads`` and ``_optimizer_update``.  The scalars, and every
    group's master (where the gradient is not summation order's sign,
    LAMB_WELL) and moments."""
    jcfg, cfg, jp, tp = model()
    kw = dict(precision="f32", accum_steps=1, optimizer="lamb",
              learning_rate=2e-3, warmup_steps=1, total_steps=3)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    batch, ((jloss, jm), jgrads) = _reference_loss()

    def update(grads, opt):
        grads, gnorm = jts._clip_grads(grads, jtcfg.grad_clip)
        opt, lr = jts._optimizer_update(grads, opt, jtcfg,
                                        skip_update=False)
        return opt, gnorm, lr
    jopt, jnorm, jlr = jax.jit(update)(
        jgrads, jts.init_train_state(jp, JPOL, jtcfg).opt)
    state = ts.init_train_state(tp, POL, tcfg, cfg=cfg)
    state, m = ts.train_step_fn(state, api.to_device(batch, "cpu"), cfg=cfg,
                                tcfg=tcfg, policy=POL)
    assert state.opt.step == int(jopt.step) == 1 and not m["skipped"]
    for k, want in (("loss", jloss), ("grad_norm", jnorm), ("lr", jlr),
                    ("lm_loss", jm["lm_loss"])):
        np.testing.assert_allclose(float(m[k]), float(want), **SCALAR_TOL,
                                   err_msg=k)
    grad = {"/".join(_key(p)): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for name, tol in (("master", MASTER_TOL), ("m", MOMENT_TOL),
                      ("v", MOMENT_TOL)):
        got = {state.opt.groups.name(p): t for p, t in
               state.opt.groups.stacked(getattr(state.opt, name)).items()}
        want = jax.tree_util.tree_flatten_with_path(getattr(jopt, name))[0]
        assert len(got) == len(want)
        for path, w in want:
            key = "/".join(_key(path))
            g, w = got[key].numpy(), np.asarray(w)
            if name == "master":
                well = np.abs(grad[key]) >= LAMB_WELL * np.abs(
                    grad[key]).max()
                g, w = g[well], w[well]
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{name} {key}")


# ---------------------------------------------------------------------------
# batches and the CLI
# ---------------------------------------------------------------------------

def test_batches_carry_vision():
    """The batch schema carries ``vision`` (B, n_vision_tokens, d_model)
    float32, the reference's; synthetic batches draw it 0.1 N(0, 1);
    ``to_device`` keeps it float32.  The trainer's stream adds the
    reference trainer's draw (``0.1 * default_rng(0).standard_normal(...)
    .astype(float32)``), the same array every step, and its resume cursor
    is the token stream's: a stream restored from a cursor gives the same
    batches, vision included."""
    jcfg, cfg, _, _ = model()
    shape, jshape = InputShape("t", 16, 2, "train"), \
        JInputShape("t", 16, 2, "train")
    struct = api.train_batch_struct(cfg, shape)
    jstruct = japi.train_batch_struct(jcfg, jshape)
    assert {k: (v.shape, np.dtype(v.dtype)) for k, v in struct.items()} == \
        {k: (v.shape, np.dtype(v.dtype)) for k, v in jstruct.items()}
    batch = api.make_synth_batch(0, cfg, shape)
    assert batch["vision"].dtype == np.float32
    assert 0.05 < float(batch["vision"].std()) < 0.2
    assert api.to_device(batch, "cpu")["vision"].dtype == torch.float32
    stream = train_cli.lm_stream(cfg, 0, 2, 16)
    want = 0.1 * np.random.default_rng(0).standard_normal(
        (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    first = next(stream)
    np.testing.assert_array_equal(first["vision"], want)
    cursor = stream.state_dict()
    second = next(stream)
    np.testing.assert_array_equal(second["vision"], want)
    stream.load_state_dict(cursor)
    again = next(stream)
    np.testing.assert_array_equal(again["tokens"], second["tokens"])
    np.testing.assert_array_equal(again["vision"], want)


def test_the_cli_trains_qwen2vl_on_the_cpu():
    """``launch/train.py --arch qwen2-vl-7b`` (the smoke variant) takes 3
    steps of 2 x 16 tokens with vision in 2 micro-batches: every loss
    finite, no step skipped; ``--full --layers 4`` is the path
    ``chip_smoke.py`` trains (only configured, not built); a ``--seq``
    shorter than the vision tokens is refused."""
    cfg, _, history = train_cli.run([
        "--device", "cpu", "--arch", ARCH, "--steps", "3", "--batch", "2",
        "--seq", "16", "--accum", "2", "--precision", "f32",
        "--log-every", "1"])
    assert cfg.n_vision_tokens == 8
    assert [r["step"] for r in history] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and not r["skipped"]
               for r in history)
    cut = train_cli.model_config(train_cli.parse_args(
        ["--arch", ARCH, "--full", "--layers", "4"]))
    assert (cut.n_layers, cut.d_model, cut.param_count()) == (
        4, 3584, 2_022_229_504)
    with pytest.raises(SystemExit, match="vision"):
        train_cli.model_config(train_cli.parse_args(
            ["--arch", ARCH, "--seq", "7"]))


CLI = ["--arch", ARCH, "--device", "cpu", "--steps", "3", "--batch", "2",
       "--seq", "16", "--precision", "f32", "--log-every", "1",
       "--ckpt-every", "1"]


def _cli(tmp, tag, faults="", extra=()):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("REPRO_FAULTS", None)
    if faults:
        env["REPRO_FAULTS"] = faults
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI,
         "--ckpt-dir", f"{tmp}/{tag}_ckpt", "--loss-log",
         f"{tmp}/{tag}.jsonl", *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


def test_cli_crash_resume_in_bits(tmp_path):
    """The smoke model through ``launch/train.py`` with its vision stream:
    3 steps uninterrupted, and crashed after step 2
    (``REPRO_FAULTS=crash_at=2``, exit 43, newest checkpoint 1) then
    ``--resume``d: the replayed steps have the uninterrupted losses'
    bits (the resumed stream's vision embeddings are the same array)."""
    ref, crash = _cli(tmp_path, "ref"), _cli(tmp_path, "crash",
                                              "crash_at=2")
    _finish(ref)
    _finish(crash, 43)
    assert latest_step(f"{tmp_path}/crash_ckpt") == 1
    resumed = _finish(_cli(tmp_path, "crash", extra=["--resume"]))
    assert "resumed from checkpoint step 1" in resumed
    want = dict(_loss_log(f"{tmp_path}/ref.jsonl"))
    got = _loss_log(f"{tmp_path}/crash.jsonl")
    assert [s for s, _ in got] == [1, 2, 2, 3]
    for s, loss in got:
        assert loss.hex() == want[s].hex(), (s, loss, want[s])
