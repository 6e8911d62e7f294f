"""The port's BERT against ``repro.models.bert`` at f32: the same weights
(carried across by ``bridge.params_from_jax``) and the same numpy batch go
through ``bert_pretrain_loss`` in both packages; loss, metrics and every
gradient leaf agree.  On the CPU the port's LayerNorm, bias-GELU and flash
attention run their plain versions (flash forward and its FA-2 backward
written out); the reference runs its jnp path (``naive_attention`` at
S <= 512), the same functions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.amp import make_policy as jmake_policy
from repro.models import api as japi
from repro.models import bert as JB
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import api, bert as TB
from repro_torch.utils import tree_leaves, tree_map
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

JCFG = jsmoke(jget_config("bert-large"), d_model=128, n_blocks=2)
CFG = smoke_variant(get_config("bert-large"), d_model=128, n_blocks=2)
# f32 on both sides; the two differ only in the order of sums (attention's
# FA-2 backward written out vs XLA's autodiff of softmax, LayerNorm's
# backward from saved statistics)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _jparams(seed=0):
    jp = jax.jit(lambda key: japi.init_params(key, JCFG)[0])(
        jax.random.PRNGKey(seed))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def make_batch(seed, b, s, n_pred, vocab):
    """A numpy batch with two segments per row, distinct sorted prediction
    positions and some padded (-100) labels."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(5, vocab, (b, s)).astype(np.int32)
    type_ids = np.zeros((b, s), np.int32)
    pos = np.zeros((b, n_pred), np.int32)
    labels = np.full((b, n_pred), -100, np.int32)
    for i in range(b):
        type_ids[i, rng.integers(s // 4, 3 * s // 4):] = 1
        n = int(rng.integers(n_pred // 2, n_pred + 1))
        pos[i, :n] = np.sort(rng.choice(np.arange(1, s), n, replace=False))
        labels[i, :n] = rng.integers(5, vocab, n)
    return {"tokens": tokens, "type_ids": type_ids, "mlm_positions": pos,
            "mlm_labels": labels,
            "nsp_labels": rng.integers(0, 2, b).astype(np.int32)}


def _port_loss_and_grads(tparams, batch, remat=False):
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = TB.bert_pretrain_loss(tparams, api.to_device(batch, "cpu"),
                                          CFG, make_policy("f32"),
                                          remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, grads


@pytest.mark.parametrize("s,b", [(128, 4), (512, 2)])
def test_loss_metrics_and_every_gradient_match_the_reference(s, b):
    jp, np_params = _jparams()
    batch = make_batch(s, b, s, api.mlm_positions_count(s), CFG.vocab_size)
    jpol = jmake_policy("f32")
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JB.bert_pretrain_loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, JCFG, jpol),
        has_aux=True))(jp)
    tparams = bridge.params_from_jax(np_params, CFG, device="cpu")
    loss, metrics, grads = _port_loss_and_grads(tparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    for k in ("mlm_loss", "nsp_loss", "mlm_acc"):
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]),
                                   **LOSS_TOL, err_msg=k)
    # every leaf, restacked into the reference's layout
    it = iter(grads)
    tgrads = bridge.params_to_numpy(tree_map(lambda _: next(it), tparams),
                                    CFG)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(tgrads)[0])
    assert len(jflat) == len(tflat) == 26
    for path, want in jflat:
        np.testing.assert_allclose(tflat[path], np.asarray(want), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_gives_the_same_gradients():
    """``remat=True`` (torch.utils.checkpoint per block) recomputes the
    forward in the backward pass: the same loss, bit for bit, and the same
    gradients up to the order in which the embedding gathers' backward sums
    repeated token rows (not fixed on the CPU: 1e-7 of 0.3 measured)."""
    _, np_params = _jparams(1)
    batch = make_batch(7, 2, 128, 20, CFG.vocab_size)
    a = _port_loss_and_grads(bridge.params_from_jax(np_params, CFG, "cpu"),
                             batch)
    b = _port_loss_and_grads(bridge.params_from_jax(np_params, CFG, "cpu"),
                             batch, remat=True)
    assert torch.equal(a[0], b[0])
    for ga, gb in zip(a[2], b[2]):
        np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_bridge_round_trips_the_stacked_bert_layout():
    """BERT's blocks are one dict stacked over the layers (the decoder's are
    a tuple per pattern position): both directions are lossless."""
    jp, np_params = _jparams(2)
    tparams = bridge.params_from_jax(np_params, CFG, device="cpu")
    assert isinstance(tparams["blocks"], list)
    assert len(tparams["blocks"]) == CFG.n_layers == 2
    np.testing.assert_array_equal(
        tparams["blocks"][1]["attn"]["wq"].numpy(),
        np_params["blocks"]["attn"]["wq"][1])
    back = bridge.params_to_numpy(tparams, CFG)
    assert isinstance(back["blocks"], dict)
    leaves_a = jax.tree_util.tree_flatten_with_path(np_params)[0]
    leaves_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(leaves_a) == len(leaves_b)
    for path, want in leaves_a:
        np.testing.assert_array_equal(leaves_b[path], want)


def test_init_bert_matches_the_reference_layout():
    """The port's seeded init has the reference's leaves, shapes and
    distributions (the values differ: torch.Generator is not jax.random)."""
    jp, _ = _jparams()
    tparams = TB.init_bert(CFG, seed=0, device="cpu")
    back = bridge.params_to_numpy(tparams, CFG)
    jshapes = jax.tree_util.tree_map(lambda x: x.shape, jp)
    tshapes = jax.tree_util.tree_map(lambda x: x.shape, back)
    assert jshapes == tshapes
    wq = tparams["blocks"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - 0.02 * 0.88) < 2e-3   # truncated at 2 sd
    assert float(wq.abs().max()) <= 0.04 + 1e-7
    assert torch.equal(tparams["embed_norm"]["bias"], torch.zeros(128))


def test_param_count_counts_learned_positions_and_the_encoder_head():
    """The analytic count agrees with the reference's for bert-large
    (learned positions counted, no untied LM head for an encoder) and the
    deepseek decoder."""
    for arch in ("bert-large", "bert-base", "deepseek-7b"):
        assert get_config(arch).param_count() == \
            jget_config(arch).param_count(), arch
    assert get_config("bert-large").param_count() == 333_818_880


def test_smoke_variant_keeps_learned_positions_at_512():
    """smoke_variant sets max_position 512 for learned-position configs,
    as the reference's does."""
    assert CFG.max_position == JCFG.max_position == 512
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab_size", "norm_eps", "mlp_kind", "norm_kind",
                 "pos_kind", "is_encoder_only"):
        assert getattr(CFG, name) == getattr(JCFG, name), name
