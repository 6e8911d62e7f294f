"""The MoE decoders' training state and CLI against the JAX package, at
``smoke_variant`` sizes on ``tests/test_torch_moe_serve.py``'s perturbed
weights (two blocks, 4 experts top-2):

* the optimizer groups (``LeafGroups``) against the reference's stacked
  tree: one group a leaf name, the expert leaves (L, E, d, f);
* the checkpoints of an MoE state after a step, interchanged with the
  reference's both ways (the reference's ``TrainState`` holds the port's
  numbers, so the two manifests must agree to the checksum);
* the twins of ``tests/test_integration.py::test_moe_router_aux_decreases_
  imbalance`` (20 steps: the aux loss stays finite and bounded) and of
  ``tests/test_smoke_archs.py::test_one_train_step`` (one finite, taken
  bf16 step) for both models;
* ``launch/train.py --device cpu`` with each ``--moe-impl``, router aux
  logged, and ``profile_train``'s MoE rows.

The step against the reference's is ``tests/test_torch_moe_train.py``."""
import dataclasses
import logging

import jax
import numpy as np
import pytest

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import amp as jamp
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.configs.base import InputShape
from repro_torch.core.amp import make_policy
from repro_torch.launch import profile_train
from repro_torch.launch import train as train_cli
from repro_torch.models import api
from repro_torch.train import train_step as ts
from repro_torch.train.checkpoint import (load_manifest, restore_checkpoint,
                                          save_checkpoint)
from test_torch_moe_serve import ARCHS, _model, _tokens
import torch_threads  # noqa: F401  (one PyTorch thread a worker)


def _key(path):
    """A reference key path as a ``LeafGroups`` path (one block-pattern
    position: the position dropped)."""
    return tuple(k.key for k in path if hasattr(k, "key"))


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_groups_match_the_reference_stacked_tree(arch):
    """The state's groups are the reference's stacked leaves: one a leaf
    name, named ``blocks/0/...`` as its checkpoints name them, a block
    leaf (L, *leaf): the router (L, d, E), ``wi`` and ``wg`` (L, E, d, f),
    ``wo`` (L, E, f, d)."""
    _, cfg, jp, tp = _model(arch, 2)
    state = ts.init_train_state(tp, make_policy("f32"),
                                TrainConfig(precision="f32", accum_steps=1),
                                cfg=cfg)
    groups = state.opt.groups
    stacked = groups.stacked(state.opt.master)
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {groups.name(p): tuple(stacked[p].shape) for p in groups.paths}
    assert got == want
    d, f, e, n = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.n_layers
    assert got["blocks/0/mlp/router"] == (n, d, e)
    assert got["blocks/0/mlp/wi"] == got["blocks/0/mlp/wg"] == (n, e, d, f)
    assert got["blocks/0/mlp/wo"] == (n, e, f, d)


@pytest.fixture(scope="module", params=ARCHS)
def stepped(request):
    """(arch, the port's state after one f32 AdamW step, the reference's
    ``TrainState`` holding the same numbers in its layout, the port's
    TrainConfig)."""
    arch = request.param
    jcfg, cfg, jp, tp = _model(arch, 2)
    kw = dict(precision="f32", accum_steps=1, optimizer="adamw",
              warmup_steps=1, total_steps=4)
    tcfg, pol = TrainConfig(**kw), make_policy("f32")
    state = ts.init_train_state(tp, pol, tcfg, cfg=cfg)
    state, _ = ts.train_step_fn(
        state, api.to_device({"tokens": _tokens(cfg, (2, 17), 31)}, "cpu"),
        cfg=cfg, tcfg=tcfg, policy=pol)
    jstate = jts.init_train_state(jp, jamp.make_policy("f32"),
                                  JTrainConfig(**kw))
    ref = {n: bridge.params_to_numpy(
        state.opt.groups.tree(getattr(state.opt, n)), cfg)
        for n in ("master", "m", "v")}
    ls = state.loss_scale
    jstate = jstate._replace(
        opt=jstate.opt._replace(step=np.int32(state.opt.step), **ref),
        loss_scale=jamp.LossScaleState(np.float32(ls.scale),
                                       np.int32(ls.good_steps),
                                       np.int32(ls.total_skipped)))
    return arch, jstate, state, tcfg


@pytest.mark.parametrize("way", ["port_to_reference", "reference_to_port"])
def test_checkpoints_interchange_both_ways(stepped, tmp_path, way):
    """A checkpoint of an MoE state (the router and the expert leaves
    stacked over the layers) written by one package restores into the
    other bit for bit, with the reference's manifest: names, shapes,
    dtypes and, for the same numbers, the same checksums."""
    arch, jstate, state, tcfg = stepped
    cfg = _model(arch, 2)[1]
    if way == "port_to_reference":
        save_checkpoint(str(tmp_path), 1, state)
        got, step = jckpt.restore_checkpoint(str(tmp_path), like=jstate)
        assert step == 1 and int(got.opt.step) == 1
        names = load_manifest(str(tmp_path), 1)["names"]
        assert "opt/master/blocks/0/mlp/wi" in names
        assert "opt/v/blocks/0/mlp/router" in names
        stacked = {n: state.opt.groups.stacked(getattr(state.opt, n))
                   for n in ("master", "m", "v")}
        for n in stacked:
            for path, w in jax.tree_util.tree_flatten_with_path(
                    getattr(got.opt, n))[0]:
                assert stacked[n][_key(path)].numpy().tobytes() == \
                    np.asarray(w).tobytes(), (n, path)
        return
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, jstate)
    fresh = ts.init_train_state(api.init_params(cfg, seed=7, device="cpu"),
                                make_policy("f32"), tcfg, cfg=cfg)
    back, step = restore_checkpoint(str(tmp_path / "ref"), fresh)
    assert back is fresh and step == 1 and back.opt.step == 1
    for n in ("master", "m", "v"):
        stacked = back.opt.groups.stacked(getattr(back.opt, n))
        for path, w in jax.tree_util.tree_flatten_with_path(
                getattr(jstate.opt, n))[0]:
            assert stacked[_key(path)].numpy().tobytes() == \
                np.asarray(w).tobytes(), (n, path)
    save_checkpoint(str(tmp_path / "port"), 1, back)
    rm = load_manifest(str(tmp_path / "ref"), 1)
    pm = load_manifest(str(tmp_path / "port"), 1)
    for key in ("names", "shapes", "dtypes", "checksums"):
        assert pm[key] == rm[key], key


# ---------------------------------------------------------------------------
# twins of the reference's MoE training tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_router_aux_stays_bounded_over_twenty_steps(arch):
    """tests/test_integration.py::test_moe_router_aux_decreases_imbalance
    on the port: d 64, aux coefficient 0.05, f32, the dense path, 20 steps
    on one 8 x 32 batch: every router_aux finite and the last under 1.5x
    the first."""
    cfg = smoke_variant(get_config(arch), d_model=64)
    cfg = dataclasses.replace(cfg, router_aux_coef=0.05)
    tcfg = TrainConfig(precision="f32", total_steps=30, warmup_steps=2,
                       learning_rate=1e-3, moe_impl="dense")
    pol = make_policy("f32")
    state = ts.init_train_state(api.init_params(cfg, seed=0, device="cpu"),
                                pol, tcfg, cfg=cfg)
    batch = api.to_device(api.make_synth_batch(
        1, cfg, InputShape("t", 32, 8, "train")), "cpu")
    auxes = []
    for _ in range(20):
        state, m = ts.train_step_fn(state, batch, cfg=cfg, tcfg=tcfg,
                                    policy=pol)
        auxes.append(float(m["router_aux"]))
    assert all(np.isfinite(a) for a in auxes)
    assert auxes[-1] < auxes[0] * 1.5


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(arch):
    """tests/test_smoke_archs.py::test_one_train_step on the port: the
    smoke model, bf16, accumulation 2, the dense path, one 4 x 32 batch:
    a finite loss, the step taken."""
    cfg = smoke_variant(get_config(arch))
    tcfg = TrainConfig(precision="bf16", accum_steps=2, total_steps=10,
                       warmup_steps=2, moe_impl="dense")
    pol = make_policy("bf16")
    state = ts.init_train_state(api.init_params(cfg, seed=0, device="cpu"),
                                pol, tcfg, cfg=cfg)
    shape = InputShape("smoke", 32, 4, "train")
    assert api.train_batch_struct(cfg, shape)["tokens"].shape == (4, 33)
    batch = api.to_device(api.make_synth_batch(1, cfg, shape), "cpu")
    state, m = ts.train_step_fn(state, batch, cfg=cfg, tcfg=tcfg,
                                policy=pol)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["router_aux"]))
    assert not m["skipped"] and state.opt.step == 1


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,moe_impl", [
    ("granite-moe-3b-a800m", "dense"), ("granite-moe-3b-a800m", "a2a"),
    ("granite-moe-3b-a800m", "replicated"), ("qwen3-moe-30b-a3b", "a2a")])
def test_train_cli_takes_the_moe_archs(arch, moe_impl, caplog):
    """``launch/train.py --arch <MoE> --moe-impl <impl> --device cpu``:
    three finite, taken steps with router_aux in the history and in each
    logged step line; a2a and replicated are the same capacity path on
    one device, so their losses agree bit for bit."""
    argv = ["--arch", arch, "--moe-impl", moe_impl, "--steps", "3",
            "--batch", "2", "--seq", "16", "--accum", "2", "--device",
            "cpu", "--log-every", "1"]
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        cfg, state, history = train_cli.run(argv)
    assert cfg.has_moe and state.opt.step == 3
    assert [r["step"] for r in history] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["router_aux"])
               and not r["skipped"] for r in history)
    assert sum("router aux" in r.message for r in caplog.records) == 3
    if moe_impl == "replicated":
        _, _, a2a = train_cli.run([a if a != "replicated" else "a2a"
                                   for a in argv])
        assert [r["loss"] for r in a2a] == [r["loss"] for r in history]


def test_cli_refuses_an_unknown_moe_impl_and_profile_train_has_the_moe_rows():
    """``--moe-impl`` takes the reference's three names only; the
    profile's training paths hold both MoE decoders, and the CLI's model
    of each row is the model at its depth."""
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--arch", "granite-moe-3b-a800m",
                              "--moe-impl", "sparse"])
    for arch in ARCHS:
        layers = profile_train.LM_PATHS[arch][0]
        cfg = train_cli.model_config(train_cli.parse_args(
            ["--arch", arch, "--full", "--layers", str(layers)]))
        assert cfg.has_moe and cfg.n_layers == layers
        assert cfg.d_model == get_config(arch).d_model
