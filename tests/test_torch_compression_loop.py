"""The supervised loop (``train/trainer.py`` ``train_loop``) over a state
with the compressed exchange's residual at world 2 (2 gloo ranks,
``torch_dp_workers.residual_loop_rank``): the emergency checkpoint is
written only where every rank reaches it at the same step, and then with
every rank's residual.  (The regular save and the resume are held in
``tests/test_torch_compression_resume.py`` and through the CLI in
``tests/test_torch_compression_cli.py``.)"""
import json

import numpy as np
import pytest

from repro_torch.launch import mesh as M

import torch_dp_workers as W
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

LOOP_CASES = ("one_rank_error", "budget", "transient")


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("residual_loop")
    for case in LOOP_CASES:
        M.spawn(W.residual_loop_rank, 2, args=(case, str(tmp)),
                device="cpu", timeout_s=30, wait_s=120)
    return tmp, {(c, r): json.loads((tmp / f"{c}_rank{r}.json").read_text())
                 for c in LOOP_CASES for r in range(2)}


def test_a_rank_local_error_writes_no_emergency_checkpoint(loops):
    """Rank 1's RuntimeError ends its run alone: its peer's next exchange
    fails, no rank can gather the residuals, and no checkpoint is written
    (none with a rank's residual missing, zeroed or stale); rank 0 warns
    and names the last regular checkpoint."""
    tmp, out = loops
    assert out[("one_rank_error", 1)]["error"] == "RuntimeError"
    assert out[("one_rank_error", 0)]["error"] is not None
    assert not list((tmp / "one_rank_error").glob("*.npz"))
    warned = [w for w in out[("one_rank_error", 0)]["warnings"]
              if "no emergency checkpoint" in w]
    assert warned and "last regular checkpoint" in warned[0] and \
        "none" in warned[0]


@pytest.mark.parametrize("case,error,step", [
    ("budget", "NonFiniteBudgetError", 2),
    ("transient", "TransientStepError", 1)])
def test_an_abort_on_every_rank_saves_every_residual(loops, case, error,
                                                     step):
    """``NonFiniteBudgetError`` and retries of ``TransientStepError`` run
    out end every rank at the same step: the ranks gather their residuals
    and rank 0 writes the emergency checkpoint with both rows (the state
    of the last completed step, rank r's residual r + 1)."""
    tmp, out = loops
    assert {out[(case, r)]["error"] for r in range(2)} == {error}
    d = tmp / case
    assert [p.name for p in d.glob("*.npz")] == [f"ckpt_{step:08d}.npz"]
    leaves = dict(_leaves_at(d, step))
    np.testing.assert_array_equal(leaves["err/w"], [[1.0] * 4, [2.0] * 4])


def _leaves_at(d, step):
    names = json.loads((d / f"ckpt_{step:08d}.json").read_text())["names"]
    with np.load(d / f"ckpt_{step:08d}.npz") as z:
        return [(n, z[f"a{i:06d}"]) for i, n in enumerate(names)]
