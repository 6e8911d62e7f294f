"""The port's decoder training against the JAX package at f32: the same
weights (``bridge.params_from_jax``) and the same numpy tokens go through
each package's ``lm_train_loss`` (the loss and every gradient group, at
S 64, where both take ``naive_attention``, and at S 640, where
S^2 > 512^2 sends the port through its flash forward and backward -- the
plain versions on the CPU -- and the reference through its jnp
FlashAttention-2 custom VJP, ``layers._flash_fn``).  Also the twin of
``tests/test_cli.py::test_model_with_pallas_attention_backend`` (a model
forward and gradient at S 1024 through the flash route) and the
refusals of what decoder training does not cover yet."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core import amp as jamp
from repro.models import api as japi
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import InputShape
from repro_torch.core import amp
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.utils import tree_leaves, tree_map
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

JCFG = jsmoke(jget_config("deepseek-7b"), n_blocks=2)
CFG = smoke_variant(get_config("deepseek-7b"), n_blocks=2)
# f32 on both sides; the two differ in the order of sums (the flash
# backward written out against XLA's autodiff, matmul blocking).
# Readings on the CPU: loss 7.6e-8 relative, every gradient group within
# 1e-6 relative L2 and 3e-8 absolute.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _params(seed=0):
    jp = jax.jit(lambda key: japi.init_params(key, JCFG)[0])(
        jax.random.PRNGKey(seed))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _tokens(seed, b, s):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


def _port_grads(np_params, loss_of):
    """(loss, metrics, gradients restacked into the reference's layout)."""
    tparams = bridge.params_from_jax(np_params, CFG, device="cpu")
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = loss_of(tparams)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss, metrics, bridge.params_to_numpy(
        tree_map(lambda _: next(it), tparams), CFG)


def _assert_grads(jgrads, tgrads):
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(tgrads)[0])
    assert len(jflat) == len(tflat) == 12
    for path, want in jflat:
        np.testing.assert_allclose(tflat[path], np.asarray(want), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _count_flash(monkeypatch):
    """Count the flash dispatchers' calls (forward and backward)."""
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("flash_attention", "fwd"),
                      ("flash_attention_bwd", "bwd")):
        real = getattr(ops, name)

        def counted(*a, real=real, key=key, **kw):
            calls[key] += 1
            return real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("s,remat", [pytest.param(64, False, id="s64"),
                                     pytest.param(640, True,
                                                  id="s640-remat")])
def test_lm_loss_and_every_gradient_match_the_reference(monkeypatch, s,
                                                         remat):
    """At S 640 the port's attention is the flash pair: two layers run the
    forward twice each under the recompute and the backward once each; at
    S 64 neither runs."""
    jp, np_params = _params()
    tokens = _tokens(s, 2, s + 1)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: japi.lm_train_loss(p, {"tokens": jnp.asarray(tokens)},
                                     JCFG, jamp.make_policy("f32"),
                                     remat=remat), has_aux=True))(jp)
    calls = _count_flash(monkeypatch)
    loss, metrics, tgrads = _port_grads(np_params, lambda p: api.lm_train_loss(
        p, api.to_device({"tokens": tokens}, "cpu"), CFG,
        amp.make_policy("f32"), remat=remat))
    assert calls == ({"fwd": 4, "bwd": 2} if s == 640 else
                     {"fwd": 0, "bwd": 0})
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    for k in ("lm_loss", "router_aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]),
                                   **LOSS_TOL, err_msg=k)
    _assert_grads(jgrads, tgrads)


def test_model_forward_and_gradient_through_the_flash_route(monkeypatch):
    """Twin of ``tests/test_cli.py::test_model_with_pallas_attention_
    backend``: ``apply_lm`` of (2, 1024) tokens and the gradient of the
    mean squared logit, the port through its flash forward and backward
    (the plain versions here), the reference through its jnp flash VJP;
    loss and every gradient group agree, and are finite and nonzero."""
    jp, np_params = _params(1)
    tokens = _tokens(5, 2, 1024)

    def jloss_fn(p):
        logits, _ = JT.apply_lm(p, jnp.asarray(tokens), JCFG,
                                jamp.make_policy("f32"))
        return jnp.mean(logits.astype(jnp.float32) ** 2)
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jp)
    calls = _count_flash(monkeypatch)

    def loss_of(p):
        logits = T.apply_lm(p, api.to_device({"t": tokens}, "cpu")["t"], CFG,
                            amp.make_policy("f32"))
        return torch.mean(logits.float() ** 2), {}
    loss, _, tgrads = _port_grads(np_params, loss_of)
    assert calls == {"fwd": 2, "bwd": 2}
    loss = float(loss.detach())
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(jloss), **LOSS_TOL)
    _assert_grads(jgrads, tgrads)
    total = sum(float(np.abs(g).sum()) for g in jax.tree_util.tree_leaves(
        tgrads))
    assert np.isfinite(total) and total > 0


def test_decoder_training_refuses_what_later_slices_bring():
    """A model with MoE layers trains now (its loss, parameters and batch
    schema are the trainer's: the loss adds the router's aux loss), and so
    does an encoder-decoder (whisper-small's smoke variant, its batch with
    frames; tests/test_torch_whisper_train.py holds it against the
    reference), and so does a model with a vision stub: its batch schema
    adds ``vision`` (B, n_vision_tokens, d_model) float32 and its loss is
    finite (tests/test_torch_qwen2vl_train.py holds qwen2-vl's against the
    reference)."""
    pol = amp.make_policy("f32")
    moe = smoke_variant(get_config("deepseek-7b"))
    moe = dataclasses.replace(moe, block_pattern=(("attn", "moe"),),
                              n_experts=4, top_k=2, moe_d_ff=64)
    params = api.init_params(moe, device="cpu")
    assert params["blocks"][0]["mlp"]["wi"].shape == (4, moe.d_model, 64)
    batch = api.train_batch_struct(moe, InputShape("t", 64, 2, "train"))
    assert batch["tokens"].shape == (2, 65)
    tokens = api.to_device({"tokens": _tokens(3, 2, 65)}, "cpu")
    loss, metrics = api.make_loss_fn(moe, pol)(params, tokens)
    assert np.isfinite(float(loss)) and float(metrics["router_aux"]) > 0
    assert float(loss) == pytest.approx(
        float(metrics["lm_loss"]) + moe.router_aux_coef
        * float(metrics["router_aux"]), rel=1e-6)
    whisper = smoke_variant(get_config("whisper-small"))
    shape = InputShape("t", 16, 2, "train")
    batch = api.to_device(api.make_synth_batch(0, whisper, shape), "cpu")
    assert batch["frames"].shape == (2, whisper.enc_seq, whisper.d_model)
    loss, _ = api.make_loss_fn(whisper, pol)(
        api.init_params(whisper, device="cpu"), batch)
    assert np.isfinite(float(loss))
    vision_like = dataclasses.replace(CFG, n_vision_tokens=8)
    batch = api.make_synth_batch(1, vision_like, shape)
    assert batch["vision"].shape == (2, 8, vision_like.d_model)
    assert batch["vision"].dtype == np.float32
    loss, metrics = api.make_loss_fn(vision_like, pol)(
        api.init_params(vision_like, device="cpu"),
        api.to_device(batch, "cpu"))
    assert np.isfinite(float(loss))
    assert float(metrics["router_aux"]) == 0.0
