"""The compressed step's residual through checkpoints at world 2, the
twin of ``tests/test_compression.py:178`` and of the resume half of
``tests/test_overlap.py:172``, and the port's compressed and overlapped
losses against the reference's ``make_train_step_dp``.

``smoke_variant(bert-large, d_model=64)`` in f32 from the reference's
seeded weights, 4 seeded global batches of 16 x 32 tokens, 2 gloo ranks
(``torch_dp_workers.resume_rank``) beside the reference over 2 forced
host devices (``run_steps``):

* int8 at accumulation 1 (``:178``) and 2, int8 with the overlapped drain
  at 2 (``:172``) and psum with the overlapped drain: 2 steps, a checkpoint
  (every rank's residual gathered to rank 0, which writes), a restore on
  every rank and 2 more steps give the bits of 4 straight steps, the
  residuals included, and the restore gives back the saved state;
* the port's int8 losses, serial and overlapped, within
  ``tests/test_torch_train.py``'s scalar tolerance of the reference's own
  runs of the same settings;
* a checkpoint with the residual is interchangeable both ways: the
  reference's (written after its 2nd int8 step) restores into each of the
  port's ranks, its row of the residual into each rank's; the port's
  restores through the reference's ``restore_checkpoint``, leaf for leaf
  the file's bits, and a residual of another world or a residual group
  where the run has none is refused with a ``ValueError``."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from conftest import SRC
from repro_torch.core.amp import make_policy
from repro_torch.train import train_step as ts
from repro_torch.train.checkpoint import restore_checkpoint
from test_torch_dp import reference_params
from test_torch_train import SCALAR_TOL

import torch_dp_workers as W
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

# buckets of 1 MiB: 8 of them, and the reference compiles its step in
# well under the file's minute
CASES = {"int8": dict(strategy="psum", accum=1, comp="int8",
                      bucket_bytes=2 ** 20),
         "int8_overlap": dict(strategy="psum", comp="int8", overlap=True,
                              bucket_bytes=2 ** 20),
         "int8_serial": dict(strategy="psum", comp="int8",
                             bucket_bytes=2 ** 20),
         "psum_overlap": dict(strategy="psum", overlap=True)}
# the reference's run: int8 with the overlapped drain, whose bits are its
# serial int8's (tests/test_overlap.py:172) as the port's are
# (tests/test_torch_overlap.py); it writes its checkpoint after step 2
REF_CASE = "int8_overlap"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comp_resume")
    params = reference_params()
    ref, port = W.run_steps(
        tmp, params, 4, 2, 1, W.resume_rank, list(CASES.values()),
        {REF_CASE: dict(CASES[REF_CASE], save_at=2)})
    return tmp, params, ref, port


def _name(case):
    return W.case_name(**CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_has_the_straight_bits(runs, case):
    _, _, _, port = runs
    name = _name(case)
    for r, got in enumerate(port):
        assert got[f"{name}/resumed/losses"].tolist() == \
            got[f"{name}/straight/losses"].tolist(), r
        assert str(got[f"{name}/resumed/digest"]) == \
            str(got[f"{name}/straight/digest"]), r
        if "int8" in case:
            assert str(got[f"{name}/resumed/residual_digest"]) == \
                str(got[f"{name}/straight/residual_digest"]), r
            assert float(got[f"{name}/straight/residual_max"]) > 0
    if "int8" in case:   # each rank its own residual
        assert str(port[0][f"{name}/straight/residual_digest"]) != \
            str(port[1][f"{name}/straight/residual_digest"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_restore_gives_back_the_saved_state(runs, case):
    _, _, _, port = runs
    name = _name(case)
    for got in port:
        assert str(got[f"{name}/restored_digest"]) == \
            str(got[f"{name}/saved_digest"])
        assert str(got[f"{name}/restored_residual"]) == \
            str(got[f"{name}/saved_residual"])


@pytest.mark.parametrize("case", ["int8_overlap", "int8_serial"])
def test_losses_match_the_reference(runs, case):
    """The reference's int8 + overlap run against the port's, and against
    the port's int8 serial run at the same accumulation."""
    _, _, ref, port = runs
    got = port[0][f"{_name(case)}/straight/losses"]
    want = ref[f"{REF_CASE}/losses"]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, **SCALAR_TOL, err_msg=case)


def _port_state(params, rank, world=2, case=REF_CASE):
    tcfg = W.step_case(**CASES[case])
    return ts.init_train_state(W.bridge.params_from_jax(params, W.DP_CFG,
                                                        device="cpu"),
                               make_policy("f32"), tcfg, cfg=W.DP_CFG,
                               world=world, rank=rank)


def test_the_references_checkpoint_restores_into_each_rank(runs):
    tmp, params, _, _ = runs
    d = str(tmp / REF_CASE)
    states = []
    for r in range(2):
        state, at = restore_checkpoint(d, _port_state(params, r))
        assert at == 2 and state.opt.step == 2
        states.append(state)
    rows = {p: np.stack([s.err[p].numpy() for s in states])
            for p in states[0].opt.groups.paths}
    with np.load(tmp / REF_CASE / "ckpt_00000002.npz") as z:
        arrays = [z[f"a{i:06d}"] for i in range(len(z.files))]
    leaves = states[0].checkpoint_leaves(rows)
    assert len(leaves) == len(arrays)
    assert any(n.startswith("err/") for n, _ in leaves)
    for (name, got), want in zip(leaves, arrays):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert states[0].digest() == states[1].digest()
    assert states[0].residual_digest() != states[1].residual_digest()


def test_a_residual_of_another_world_or_none_is_refused(runs):
    tmp, params, _, _ = runs
    d = tmp / REF_CASE
    with pytest.raises(ValueError, match="world 2, this run's world is 4"):
        _port_state(params, 0, world=4).load_checkpoint_leaves(_leaves(d))
    with pytest.raises(ValueError, match="residual group and this state "
                                         "has none"):
        _port_state(params, 0, case="psum_overlap").load_checkpoint_leaves(
            _leaves(d))
    # through the trainer's resume: refused, not a fresh start over it
    from repro_torch.train.trainer import train_loop
    state = _port_state(params, 0, case="psum_overlap")
    with pytest.raises(ValueError, match="cannot resume"):
        train_loop(lambda s, b: (s, {"loss": 0.0}), state, iter(range(3)),
                   total_steps=3, ckpt_dir=str(d), resume=True)


def _leaves(d):
    import json
    names = json.loads((d / "ckpt_00000002.json").read_text())["names"]
    with np.load(d / "ckpt_00000002.npz") as z:
        return [(n, z[f"a{i:06d}"]) for i, n in enumerate(names)]


REF_RESTORE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import TrainConfig
from repro.core.amp import make_policy
from repro.train.checkpoint import restore_checkpoint
from repro.train.train_step import init_train_state
params = jax.tree_util.tree_map(
    jnp.asarray, np.load(sys.argv[1], allow_pickle=True)["params"].item())
tcfg = TrainConfig(precision="f32", accum_steps=2, grad_compression="int8",
                   overlap_exchange=True, bucket_bytes=2 ** 20,
                   total_steps=50, warmup_steps=2)
like = init_train_state(params, make_policy("f32"), tcfg, world=2)
state, at = restore_checkpoint(sys.argv[2], like)
assert at == 2, at
leaves = jax.tree_util.tree_leaves(state)
with np.load(sys.argv[2] + "/ckpt_00000002.npz") as z:
    assert len(z.files) == len(leaves)
    for i, leaf in enumerate(leaves):
        a = z[f"a{i:06d}"]
        assert np.asarray(leaf).dtype == a.dtype, i
        np.testing.assert_array_equal(np.asarray(leaf), a, err_msg=str(i))
assert len(jax.tree_util.tree_leaves(state.err)) == 26
print("OK", int(state.opt.step))
"""


def test_the_ports_checkpoint_restores_into_the_reference(runs):
    tmp, _, _, _ = runs
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REF_RESTORE),
         str(tmp / "params.npz"), str(tmp / f"ckpt_{_name(REF_CASE)}")],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "OK 2" in proc.stdout, \
        proc.stdout + proc.stderr

