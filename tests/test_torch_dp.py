"""The port's data-parallel train step (``train/train_step.py``
``make_train_step_dp``) against the reference's, a twin of
``tests/test_multidevice.py:79``: psum and ring here, bucketed and
hierarchical in ``tests/test_torch_dp_hier.py`` (one file would take more
than a minute, most of it the reference compiling four steps).

``smoke_variant(bert-large, d_model=64)`` (1 layer) in f32, accumulation
2, one global batch of 16 x 32 tokens, the reference's weights carried to
the port by ``bridge``.  The reference runs ``make_train_step_dp`` on a
(4,) ``("data",)`` mesh in a subprocess over 4 forced host devices; the
port runs on 4 gloo ranks in 2 pods at the same time
(``torch_dp_workers.run_dp``).  After one step, the loss and gradient
norm agree within ``SCALAR_TOL``, every master group within
``MASTER_TOL`` and every moment group within ``MOMENT_TOL``
(``tests/test_torch_train.py``'s), and every rank holds the same state
bits (its ``TrainState.digest``).

Also: at world 1 the DP step gives the bits of ``train_step_fn``; and in
f16, one rank's gradient made non-finite in that rank's process alone,
every rank skips the update, backs the loss scale off the same way and
keeps its state bit for bit."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import api as japi
from repro_torch.launch import mesh as M
from repro_torch.train import train_step as ts
from test_torch_train import MASTER_TOL, MOMENT_TOL, SCALAR_TOL

import torch_dp_workers as W
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

STRATEGIES = ("psum", "ring")


def reference_params():
    """The reference's seeded weights of the smoke config, as numpy."""
    jcfg = jsmoke(jget_config("bert-large"), d_model=64)
    jparams = jax.jit(lambda key: japi.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jparams)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return W.run_dp(tmp_path_factory.mktemp("dp"), reference_params(),
                    W.dp_batch(5), STRATEGIES, STRATEGIES, extras=True)


def check_against_reference(ref, port, strategy):
    got = port[(strategy, 0)]
    assert int(got["opt/step"]) == int(ref[f"{strategy}/opt/step"]) == 1
    for k in ("loss", "grad_norm", "lr", "mlm_loss", "nsp_loss"):
        np.testing.assert_allclose(got[f"metric/{k}"],
                                   ref[f"{strategy}/metric/{k}"],
                                   **SCALAR_TOL, err_msg=f"{strategy} {k}")
    assert not got["metric/skipped"]
    groups = [k for k in got if k.split("/")[0] in ("master", "m", "v")]
    assert len(groups) == 3 * 26
    for key in groups:
        tol = MASTER_TOL if key.startswith("master/") else MOMENT_TOL
        np.testing.assert_allclose(got[key], ref[f"{strategy}/{key}"], **tol,
                                   err_msg=f"{strategy} {key}")


def check_every_rank_the_same(port, strategy):
    first = port[(strategy, 0)]
    for r in range(1, 4):
        other = port[(strategy, r)]
        assert str(other["digest"]) == str(first["digest"]), (strategy, r)
        for k, v in first.items():
            np.testing.assert_array_equal(other[k], v, err_msg=f"{r} {k}")


def check_agrees_with_psum(port, strategy):
    """The reference's own check (``test_multidevice.py:114-116``), on the
    port alone: every master within rtol 1e-5, atol 1e-6 of psum's, the
    loss within rtol 1e-5."""
    base, got = port[("psum", 0)], port[(strategy, 0)]
    for k in (k for k in base if k.startswith("master/")):
        np.testing.assert_allclose(got[k], base[k], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{strategy} {k}")
    np.testing.assert_allclose(got["metric/loss"], base["metric/loss"],
                               rtol=1e-5, err_msg=strategy)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dp_step_matches_the_reference(runs, strategy):
    ref, port, _ = runs
    check_against_reference(ref, port, strategy)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_every_rank_holds_the_same_state(runs, strategy):
    check_every_rank_the_same(runs[1], strategy)


def test_ring_agrees_with_psum(runs):
    check_agrees_with_psum(runs[1], "ring")


def test_world_1_dp_step_is_the_single_card_step(runs):
    _, _, w1 = runs
    dp, single = w1["dp"], w1["single"]
    assert str(dp["digest"]) == str(single["digest"])
    assert sorted(dp) == sorted(single)
    for k, v in single.items():
        np.testing.assert_array_equal(dp[k], v, err_msg=k)


def test_f16_non_finite_on_one_rank_skips_on_every_rank(runs):
    _, port, _ = runs
    ranks = [port[("f16", r)] for r in range(4)]
    for r, got in enumerate(ranks):
        assert bool(got["after/metric/skipped"]), r
        assert not np.isfinite(got["after/metric/loss"]), r
        np.testing.assert_array_equal(got["before/loss_scale"],
                                      [2.0 ** 15, 5, 0])
        np.testing.assert_array_equal(got["after/loss_scale"],
                                      [2.0 ** 14, 0, 1])
        assert int(got["after/opt/step"]) == int(got["before/opt/step"]) == 0
        for k in (k for k in got if k.startswith("before/")
                  and k.split("/")[1] in ("master", "m", "v")):
            np.testing.assert_array_equal(
                got["after/" + k[len("before/"):]], got[k], err_msg=f"{r} {k}")
        assert str(got["after/digest"]) == str(ranks[0]["after/digest"])


def test_the_dp_step_refuses_a_batch_it_cannot_split():
    """The global batch must split into world x accum_steps equal parts,
    as the reference's batch sharding and accumulation need."""
    mesh = M.DPMesh(0, 4, 1, torch.device("cpu"))
    step = ts.make_train_step_dp(W.DP_CFG, W.dp_tcfg("psum"), mesh)
    batch = {k: torch.from_numpy(v[:12]).long()
             for k, v in W.dp_batch(0).items()}
    with pytest.raises(ValueError, match="not divisible by world 4 x "
                                         "accum_steps 2"):
        step(None, batch)
