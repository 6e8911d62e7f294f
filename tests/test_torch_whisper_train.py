"""Training whisper-small on the port against the JAX package, at
``smoke_variant`` sizes (``tests/torch_whisper.py``: 2 encoder and 2
decoder layers, perturbed weights carried across by ``bridge``), in f32:

* ``lm_train_loss`` with the batch's frames, the port's recompute off
  and on, against ``jax.grad`` of the reference's (its recompute on, as
  the training step runs it): the loss and every gradient, the encoder's
  layers, ``enc_pos``, ``enc_norm`` and each decoder layer's cross
  sublayer included;
* one LAMB and one AdamW step against the reference's update, taken
  through its own ``_clip_grads`` and ``_optimizer_update`` on its
  gradient, at ``tests/test_torch_moe_train.py``'s tolerances;
* the optimizer groups against the reference's stacked tree (the
  encoder's leaves ``enc_blocks/0/...``, one LAMB trust ratio over the
  stacked layers), and checkpoints both ways;
* the batch schema and synthetic batches with frames, the trainer's
  frames (the reference's rule) and the training CLI on the CPU."""
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
from repro_torch import bridge
from repro_torch.configs import TrainConfig
from repro_torch.configs.base import InputShape
from repro_torch.launch import train as train_cli
from repro_torch.models import api
from repro_torch.train import train_step as ts
from repro_torch.train.checkpoint import (load_manifest, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.utils import tree_leaves, tree_map
from test_torch_moe_grad import F32_GRAD_RTOL, LOSS_TOL
from test_torch_moe_train import (ADAMW_MOMENT_REL_L2, ADAMW_UPDATE_REL_L2,
                                  ADAMW_WELL, MASTER_TOL, MOMENT_TOL,
                                  SCALAR_TOL)
from torch_whisper import ARCH, JPOL, POL, frames, model, tokens
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

# f32 gradients: rtol F32_GRAD_RTOL and an absolute part of GRAD_ATOL of
# the leaf's largest element (summation order only; the largest reading
# on the CPU, |port - reference| / max|reference| over the leaves, is
# ~1e-6)
GRAD_ATOL = 1e-5
TOKENS = (2, 13)


def _key(path):
    """A reference key path as a ``LeafGroups`` path."""
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _batch(cfg, seed=71):
    return {"tokens": tokens(cfg, TOKENS, seed),
            "frames": frames(cfg, TOKENS[0], seed + 1)}


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


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=F32_GRAD_RTOL,
        atol=GRAD_ATOL * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_the_reference(remat):
    """The loss, lm_loss and every gradient leaf of ``lm_train_loss`` from
    tokens and frames: the decoder's self-attention, cross sublayer
    (``norm_cross``, ``cross``) and MLP of each layer, the encoder's
    layers, ``enc_pos``, ``enc_norm``, the tied table and the learned
    positions; the port's recompute off and on (the encoder's layers are
    recomputed too)."""
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
    assert {"enc_pos", "enc_norm/scale", "enc_blocks/0/mixer/wq",
            "blocks/0/cross/wk", "blocks/0/norm_cross/bias",
            "embed/pos"} <= names
    for path, want in jflat:
        _close(tflat[path], want, jax.tree_util.keystr(path))


def _like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) laid out as ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@pytest.mark.parametrize("optimizer", ["lamb", "adamw"])
def test_train_step_matches_the_reference(optimizer):
    """One f32 step of the port's ``train_step_fn`` (TOKENS with their
    frames in one micro-batch, the recompute on) from the reference's
    weights against the reference's step through its own functions: its
    jitted gradient of the same loss, then its ``_clip_grads`` and
    ``_optimizer_update`` (the step's tail at accumulation 1 in f32).  The
    scalars, and every group's master and moments, the encoder's stacked
    groups (one LAMB trust ratio over their 2 layers) included."""
    jcfg, cfg, jp, tp = model()
    kw = dict(precision="f32", accum_steps=1, optimizer=optimizer,
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
    start = {state.opt.groups.name(p): t.clone() for p, t in
             state.opt.groups.stacked(state.opt.master).items()}
    state, m = ts.train_step_fn(state, api.to_device(batch, "cpu"), cfg=cfg,
                                tcfg=tcfg, policy=POL)
    assert state.opt.step == int(jopt.step) == 1 and not m["skipped"]
    for k, want in (("loss", jloss), ("grad_norm", jnorm), ("lr", jlr),
                    ("lm_loss", jm["lm_loss"])):
        np.testing.assert_allclose(float(m[k]), float(want), **SCALAR_TOL,
                                   err_msg=k)
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
    jcfg, cfg, jp, tp = model()
    kw = dict(precision="f32", accum_steps=1, optimizer="adamw",
              warmup_steps=1, total_steps=4)
    tcfg = TrainConfig(**kw)
    state = ts.init_train_state(tp, POL, tcfg, cfg=cfg)
    state, _ = ts.train_step_fn(state, api.to_device(_batch(cfg, 73), "cpu"),
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
    """The state's groups are the reference's stacked leaves, named as
    its checkpoints name them: the decoder's ``blocks/0/...`` (the cross
    sublayer's among them) and the encoder's ``enc_blocks/0/...``, each
    over its 2 layers, ``enc_pos`` and ``enc_norm`` outside."""
    jstate, state, _ = stepped
    groups = state.opt.groups
    stacked = groups.stacked(state.opt.master)
    want = {"/".join(_key(path)): tuple(np.shape(x)) for path, x in
            jax.tree_util.tree_flatten_with_path(jstate.opt.master)[0]}
    got = {groups.name(p): tuple(stacked[p].shape) for p in groups.paths}
    assert got == want
    cfg = model()[1]
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    assert got["enc_blocks/0/mixer/wq"] == (2, d, h, dh)
    assert got["enc_blocks/0/mlp/wi"] == (2, d, cfg.d_ff)
    assert got["blocks/0/cross/wo"] == (2, h, dh, d)
    assert got["enc_pos"] == (cfg.enc_seq, d)
    # the tree the groups lay out back is the model's, encoder included
    tree = groups.tree(state.opt.master)
    assert len(tree["enc_blocks"]) == 2 and len(tree["blocks"]) == 2


@pytest.mark.parametrize("way", ["port_to_reference", "reference_to_port"])
def test_checkpoints_interchange_both_ways(stepped, tmp_path, way):
    """A checkpoint of whisper's state written by one package restores
    into the other bit for bit, with the reference's manifest: names,
    shapes, dtypes and, for the same numbers, the same checksums."""
    jstate, state, tcfg = stepped
    cfg = model()[1]
    if way == "port_to_reference":
        save_checkpoint(str(tmp_path), 1, state)
        got, step = jckpt.restore_checkpoint(str(tmp_path), like=jstate)
        assert step == 1 and int(got.opt.step) == 1
        names = load_manifest(str(tmp_path), 1)["names"]
        assert "opt/master/enc_blocks/0/mixer/wq" in names
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


# ---------------------------------------------------------------------------
# batches and the CLI
# ---------------------------------------------------------------------------

def test_batches_carry_frames():
    """The batch schema and synthetic batches carry ``frames`` (B,
    enc_seq, d_model) float32, the reference's; ``to_device`` keeps them
    float32 (the tokens int64); the trainer's stream adds the reference's
    frames, 0.1 N(0, 1) from ``default_rng(0)`` every batch, and forwards
    the token stream's resume cursor."""
    jcfg, cfg, _, _ = model()
    shape = InputShape("t", 16, 2, "train")
    struct = api.train_batch_struct(cfg, shape)
    jstruct = japi.train_batch_struct(jcfg, shape)
    assert {k: (v.shape, np.dtype(v.dtype)) for k, v in struct.items()} == \
        {k: (v.shape, np.dtype(v.dtype)) for k, v in jstruct.items()}
    batch = api.make_synth_batch(0, cfg, shape)
    assert batch["frames"].dtype == np.float32
    assert 0.05 < float(batch["frames"].std()) < 0.2
    dev = api.to_device(batch, "cpu")
    assert dev["frames"].dtype == torch.float32
    assert dev["tokens"].dtype == torch.int64
    stream = train_cli.lm_stream(cfg, 0, 2, 16)
    first = next(stream)
    # the reference trainer's expression (repro/launch/train.py), float32
    # before the product
    want = 0.1 * np.random.default_rng(0).standard_normal(
        (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(first["frames"], want)
    cursor = stream.state_dict()
    second = next(stream)
    stream.load_state_dict(cursor)
    np.testing.assert_array_equal(next(stream)["tokens"], second["tokens"])


def test_the_cli_trains_whisper_on_the_cpu():
    """``launch/train.py --arch whisper-small`` (the smoke variant) takes
    3 steps of 2 x 16 tokens with frames in 2 micro-batches: every loss
    finite, no step skipped; ``--full --layers 1`` cuts the encoder to one
    layer too (the model is only configured, not built)."""
    cfg, _, history = train_cli.run([
        "--device", "cpu", "--arch", ARCH, "--steps", "3", "--batch", "2",
        "--seq", "16", "--accum", "2", "--precision", "f32",
        "--log-every", "1"])
    assert [r["step"] for r in history] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and not r["skipped"]
               for r in history)
    cut = train_cli.model_config(train_cli.parse_args(
        ["--arch", ARCH, "--full", "--layers", "1"]))
    assert (cut.n_layers, cut.n_enc_layers, cut.d_model) == (1, 1, 768)
