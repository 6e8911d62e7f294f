"""Training the dense decoder variants (gemma2-27b, qwen1.5-32b,
deepseek-coder-33b) against the JAX package at f32, at ``smoke_variant``
sizes: the same weights (``bridge.params_from_jax``; qwen's QKV biases
drawn away from their zero init on both sides) and the same numpy tokens.
One step of each package's train step under LAMB and AdamW is
``tests/test_torch_variants_step.py``.

* the loss and every gradient group (the tied table's, the post-norms'
  and the biases' included) through each package's ``lm_train_loss`` with
  the recompute, at S 64 (both take ``naive_attention``) and at S 640
  (S^2 > 512^2: the port's flash pair -- the plain versions on the CPU --
  behind the GQA expansion, the reference's jnp FlashAttention-2 VJP,
  which groups the queries; gemma2's smoke window of 16 masks there);
* the expanded GQA backward against the grouped-query plain backward
  (autograd through ``naive_attention``, and the reference's jnp VJP), the
  same bits on two calls;
* the checkpoints of a grouped gemma2 state (one stacked group per
  block-pattern position) and of qwen's biases, interchanged with the
  reference's both ways;
* the CLI's depth cut (gemma2 at one layer) and its refusal.
"""
import functools

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
from repro.models import layers as JL
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.core import amp
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.train import train_step as ts
from repro_torch.train.checkpoint import (load_manifest, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.utils import tree_leaves, tree_map
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ARCHS = ("gemma2-27b", "qwen1.5-32b", "deepseek-coder-33b")
# f32 on both sides; the two differ in the order of sums (the flash
# backward written out against XLA's autodiff, matmul blocking, the
# GQA group sum against the reference's grouped einsums).  Readings on
# the CPU: loss within 1.6e-7 relative; every gradient group within 1e-5
# relative L2 (qwen's at S 640 the largest) and 1.1e-7 absolute.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# QKV biases drawn at this std (init leaves zeros), so the bias path
# carries weight in the forward
BIAS_STD = 0.5
POL = amp.make_policy("f32")
JPOL = jamp.make_policy("f32")


def _cfgs(arch):
    return jsmoke(jget_config(arch)), smoke_variant(get_config(arch))


@functools.lru_cache(maxsize=None)
def _np_params(arch, seed):
    jcfg, _ = _cfgs(arch)
    jp = jax.jit(lambda key: japi.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, jp)


def _params(arch, seed=0):
    """(reference params, their numpy leaves) with qwen's biases drawn."""
    jcfg, _ = _cfgs(arch)
    np_params = jax.tree_util.tree_map(np.array, _np_params(arch, seed))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed + 1)
        for pos in np_params["blocks"]:
            for name in ("bq", "bk", "bv"):
                b = pos["mixer"][name]
                pos["mixer"][name] = (BIAS_STD * rng.standard_normal(
                    b.shape)).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, np_params), np_params


def _tokens(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _count_flash(monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("flash_attention", "fwd"),
                      ("flash_attention_bwd", "bwd")):
        real = getattr(ops, name)

        def counted(*a, real=real, key=key, **kw):
            calls[key] += 1
            return real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    return calls


def _key(path, positions):
    """A reference key path as a ``LeafGroups`` path: the block pattern
    position kept only where the pattern has more than one."""
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(k.key)
        elif positions > 1:
            out.append(str(k.idx))
    return tuple(out)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [64, 640])
def test_loss_and_every_gradient_match_the_reference(monkeypatch, arch, s):
    """With the recompute: at S 640 every layer's flash forward runs twice
    (the recompute) and its backward once; at S 64 neither runs."""
    jcfg, cfg = _cfgs(arch)
    jp, np_params = _params(arch)
    tokens = _tokens(cfg, s, 2, s + 1)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: japi.lm_train_loss(p, {"tokens": t}, jcfg, JPOL,
                                        remat=True),
        has_aux=True))(jp, jnp.asarray(tokens))
    calls = _count_flash(monkeypatch)
    tparams = bridge.params_from_jax(np_params, cfg, device="cpu")
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = api.lm_train_loss(
        tparams, api.to_device({"tokens": tokens}, "cpu"), cfg, POL,
        remat=True)
    grads = torch.autograd.grad(loss, leaves)
    n = cfg.n_layers
    assert calls == ({"fwd": 2 * n, "bwd": n} if s == 640 else
                     {"fwd": 0, "bwd": 0})
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(metrics["lm_loss"]),
                               float(jmet["lm_loss"]), **LOSS_TOL)
    it = iter(grads)
    tgrads = dict(jax.tree_util.tree_flatten_with_path(bridge.params_to_numpy(
        tree_map(lambda _: next(it), tparams), cfg))[0])
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tgrads)
    names = {jax.tree_util.keystr(p) for p, _ in jflat}
    if cfg.tie_embeddings:
        assert not any("lm_head" in k for k in names)
        assert any("postnorm1" in k for k in names)
    if cfg.qkv_bias:
        assert sum("'bq'" in k or "'bk'" in k or "'bv'" in k
                   for k in names) == 3
    for path, want in jflat:
        got = tgrads[path]
        assert np.abs(np.asarray(want)).max() > 0, path
        np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _attn_inputs(seed, b, s, h, kvh, dh=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, s, h, dh), (b, s, kvh, dh), (b, s, kvh, dh), (b, s, h, dh))]


@pytest.mark.parametrize("h,kvh,window,softcap", [
    pytest.param(4, 2, 0, 0.0, id="g2"),
    pytest.param(4, 1, 0, 0.0, id="g4"),
    pytest.param(7, 1, 0, 0.0, id="g7"),
    pytest.param(4, 2, 16, 50.0, id="g2-window-softcap")])
def test_expanded_gqa_backward_equals_the_grouped_plain_backward(
        h, kvh, window, softcap):
    """``chunked_attention``'s recorded call at S 256 (K and V expanded
    over the group, the flash pair's plain versions, dK and dV summed over
    the group by autograd) against the grouped-query plain backward:
    autograd through ``naive_attention`` (queries grouped over each KV
    head) and the reference's jnp FlashAttention-2 VJP (``_flash_fn``,
    grouped likewise); and the same bits on two calls.  f32: the readings
    are within 1.1e-5 of each other (G 7 the largest)."""
    q, k, v, do = _attn_inputs(h * 10 + kvh + window, 2, 256, h, kvh)
    kw = dict(causal=True, window=window, softcap=softcap)

    def port(fn):
        ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fn(*ins, **kw)
        return [out.detach()] + list(torch.autograd.grad(
            out, ins, torch.from_numpy(do)))

    calls = port(L.chunked_attention)
    again = port(L.chunked_attention)
    grouped = port(L.naive_attention)
    fn = JL._flash_fn(True, window, softcap, 128, 128, jnp.float32)
    jout, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    ref = [jout] + list(vjp(jnp.asarray(do)))
    for name, a, b, c, r in zip(("out", "dq", "dk", "dv"), calls, again,
                                grouped, ref):
        assert torch.equal(a, b), name
        assert a.shape == c.shape
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=2e-5, err_msg=name)


def test_the_plain_flash_backward_takes_query_rows_in_blocks(monkeypatch):
    """The plain backward takes query rows in blocks of at most
    ``QUERY_BLOCK_SCORES`` scores (gemma2's S 8192 on the card): forced to
    blocks of 24 rows, with GQA, a window and a softcap, it agrees with one
    block within f32 rounding (dK and dV summed over the blocks in
    order)."""
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2) for x in
                   _attn_inputs(5, 2, 256, 4, 2))
    kw = dict(causal=True, window=16, softcap=50.0)
    out, lse = ref.flash_attention_ref(q, k, v, **kw)
    whole = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    monkeypatch.setattr(ref, "QUERY_BLOCK_SCORES", 2 * 4 * 256 * 24)
    blocks = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), blocks, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen1.5-32b"])
def test_checkpoints_interchange_with_the_reference(tmp_path, arch):
    """The port's checkpoint of a state after one AdamW step (gemma2:
    ``blocks/0/...`` local and ``blocks/1/...`` global groups, the tied
    table and no ``lm_head``; qwen: the biases) has the reference's
    manifest names, shapes and dtypes, restores into the reference's
    ``TrainState`` with every leaf in bits, and the reference's checkpoint
    of it restores into a fresh port state in bits."""
    jcfg, cfg = _cfgs(arch)
    jp, np_params = _params(arch)
    tcfg = TrainConfig(precision="f32", accum_steps=1, optimizer="adamw",
                       warmup_steps=1, total_steps=3)
    npos = len(cfg.block_pattern)
    state = ts.init_train_state(
        bridge.params_from_jax(np_params, cfg, device="cpu"), POL, tcfg,
        cfg=cfg)
    state, _ = ts.train_step_fn(state, api.to_device(
        {"tokens": _tokens(cfg, 3, 2, 65)}, "cpu"), cfg=cfg, tcfg=tcfg,
        policy=POL)
    port, ref = tmp_path / "port", tmp_path / "ref"
    save_checkpoint(str(port), 1, state)
    like = jts.init_train_state(jp, JPOL, JTrainConfig(optimizer="adamw"))
    got, step = jckpt.restore_checkpoint(str(port), like=like)
    assert step == 1 and int(got.opt.step) == 1
    names = load_manifest(str(port), 1)["names"]
    if npos > 1:
        assert "opt/master/blocks/1/mixer/wq" in names
        assert not any("lm_head" in n for n in names)
    if cfg.qkv_bias:
        assert "opt/m/blocks/0/mixer/bq" in names
    jckpt.save_checkpoint(str(ref), 1, got)
    rm, pm = load_manifest(str(ref), 1), load_manifest(str(port), 1)
    for key in ("names", "shapes", "dtypes", "checksums"):
        assert pm[key] == rm[key], key
    fresh = ts.init_train_state(api.init_params(cfg, seed=7, device="cpu"),
                                POL, tcfg, cfg=cfg)
    back, step = restore_checkpoint(str(ref), fresh)
    assert step == 1 and back.opt.step == 1
    for name in ("master", "m", "v"):
        for p, t in getattr(state.opt, name).items():
            assert torch.equal(getattr(back.opt, name)[p], t), (name, p)
    stacked = state.opt.groups.stacked(state.opt.master)
    for path, w in jax.tree_util.tree_flatten_with_path(got.opt.master)[0]:
        assert stacked[_key(path, npos)].numpy().tobytes() == \
            np.asarray(w).tobytes(), path


def test_the_state_is_grouped_as_the_config_stacks_its_layers():
    """gemma2's local and global layers are stacked apart by the
    reference: ``init_train_state`` takes the grouping from the config, one
    group a leaf name and position (its own LAMB trust ratio), each over
    its position's layers; it takes no state without the config."""
    _, cfg = _cfgs("gemma2-27b")
    tcfg = TrainConfig(precision="f32", accum_steps=1)
    params = api.init_params(cfg, device="cpu")
    groups = ts.init_train_state(params, POL, tcfg, cfg=cfg).opt.groups
    names = {groups.name(p): groups.layers[p] for p in groups.paths}
    per = cfg.n_layers // 2
    assert names["blocks/0/mixer/wq"] == names["blocks/1/mixer/wq"] == per
    assert not any(n.startswith("blocks/mixer") for n in names)
    with pytest.raises(TypeError, match="cfg"):
        ts.init_train_state(params, POL, tcfg)


def test_cli_trains_gemma2_at_one_layer_and_refuses_a_broken_pattern():
    """``--layers 1`` keeps gemma2's first (local) layer alone; 3 neither
    tiles the two-position pattern nor is fewer than it."""
    cfg, _, history = train_cli.run([
        "--arch", "gemma2-27b", "--layers", "1", "--steps", "2", "--batch",
        "2", "--seq", "32", "--precision", "f32", "--device", "cpu",
        "--log-every", "1"])
    assert cfg.n_layers == 1
    assert cfg.block_pattern == (("attn_local", "dense"),)
    assert [r["step"] for r in history] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in history)
    with pytest.raises(SystemExit, match="block pattern"):
        train_cli.model_config(
            train_cli.parse_args(["--arch", "gemma2-27b", "--layers", "3"]))
