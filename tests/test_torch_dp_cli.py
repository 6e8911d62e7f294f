"""``--dp`` through the real CLI: ``python -m torch.distributed.run
--standalone --nproc-per-node N -m repro_torch.launch.pretrain_bert
--device cpu --dp`` on gloo, at 2 layers and d_model 32 (12 phase-1 steps
with checkpoints at 10 and 12, 1 phase-2 step, every loss logged).

* ``--strategy ring`` and ``hierarchical`` (psum at world 2: the CLI's
  mesh has no pod axis, as the reference example's) run at world 2 with
  finite losses, and both ranks end with the same state digest and the
  same loss bits;
* rank 0 alone writes the checkpoints and the loss log;
* ``REPRO_FAULTS=crash_at=11`` then ``--resume`` at world 2 gives the
  uninterrupted world-2 run's losses in bits;
* ``--dp`` at world 1 gives the losses of the run without ``--dp`` in
  bits;
* ``launch/dp_check.py`` on 4 gloo ranks in 2 pods (d_model 32) holds every
  check and reports every strategy.

Every run has a timeout; a run that outlives it is killed with its
ranks."""
import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import SRC
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

STEPS, CRASH = 13, 11
LOGGED = [("phase1", s) for s in range(1, 13)] + [("phase2", 1)]
DIGEST = re.compile(r"\[INFO repro_torch.pretrain_bert rank (\d)\] dp rank "
                    r"\d of (\d): state digest (\w+), losses (\[.*\])")


def _cli(tmp, tag, nproc=2, extra=(), faults="", dp=True):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("REPRO_FAULTS", None)
    if faults:
        env["REPRO_FAULTS"] = faults
    args = ["--device", "cpu", "--steps", str(STEPS), "--batch", "8",
            "--accum", "1", "--d-model", "32", "--workdir", f"{tmp}/{tag}",
            "--loss-log", f"{tmp}/{tag}.jsonl", *extra]
    if dp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(nproc), "-m",
               "repro_torch.launch.pretrain_bert", "--dp", *args]
    else:
        cmd = [sys.executable, "-m", "repro_torch.launch.pretrain_bert",
               *args]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _finish(proc, ok=True):
    try:
        out, _ = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"timed out and killed:\n{out[-4000:]}")
    assert (proc.returncode == 0) == ok, \
        f"exit {proc.returncode}:\n{out[-6000:]}"
    return out


def _lines(path):
    """((phase, step), loss) for each line of a ``--loss-log`` file."""
    return [((r["phase"], r["step"]), r["loss"])
            for r in map(json.loads, Path(path).read_text().splitlines())]


def _loss_log(path):
    """{(phase, step): loss} of a run that logged each step once."""
    lines = _lines(path)
    out = dict(lines)
    assert len(out) == len(lines), f"a step logged twice in {path}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp_cli"))
    procs = {"ring": _cli(tmp, "ring", extra=["--strategy", "ring"]),
             "hier": _cli(tmp, "hier", extra=["--strategy", "hierarchical"]),
             "crash": _cli(tmp, "crash", extra=["--strategy", "ring"],
                           faults=f"crash_at={CRASH}"),
             "w1": _cli(tmp, "w1", nproc=1),
             "plain": _cli(tmp, "plain", dp=False)}
    outs = {k: _finish(p, ok=k != "crash") for k, p in procs.items()}
    procs = {"resume": _cli(tmp, "crash", extra=["--strategy", "ring",
                                                 "--resume"]),
             "dp_check": subprocess.Popen(
                 [sys.executable, "-m", "repro_torch.launch.dp_check",
                  "--device", "cpu", "--world", "4", "--pods", "2",
                  "--d-model", "32", "--batch", "16", "--timeout", "60"],
                 env=dict(os.environ, PYTHONPATH=str(SRC)),
                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                 start_new_session=True)}
    outs.update({k: _finish(p) for k, p in procs.items()})
    return tmp, outs


@pytest.mark.parametrize("tag", ["ring", "hier"])
def test_both_ranks_end_with_the_same_state_and_losses(runs, tag):
    tmp, outs = runs
    found = {int(m[0]): m for m in DIGEST.findall(outs[tag])}
    assert sorted(found) == [0, 1] and found[0][1] == "2"
    assert found[0][2] == found[1][2]
    assert found[0][3] == found[1][3]
    losses = [float.fromhex(h) for h in json.loads(found[0][3])]
    assert len(losses) == len(LOGGED) and np.all(np.isfinite(losses))
    assert [h for h in json.loads(found[0][3])] == \
        [v.hex() for v in _loss_log(f"{tmp}/{tag}.jsonl").values()]


@pytest.mark.parametrize("tag", ["ring", "hier"])
def test_rank_0_alone_writes_checkpoints_and_the_loss_log(runs, tag):
    tmp, outs = runs
    assert sorted(_loss_log(f"{tmp}/{tag}.jsonl")) == sorted(LOGGED)
    saves = re.findall(r"rank (\d)\] checkpoint step (\d+) saved in \S+/(\w+):",
                       outs[tag])
    assert saves == [("0", "10", "phase1"), ("0", "12", "phase1"),
                     ("0", "1", "phase2")]
    ckpts = sorted(p.relative_to(f"{tmp}/{tag}/ckpt").as_posix()
                   for p in Path(f"{tmp}/{tag}/ckpt").glob("*/*.npz"))
    assert ckpts == ["phase1/ckpt_00000010.npz", "phase1/ckpt_00000012.npz",
                     "phase2/ckpt_00000001.npz"]
    # the non-lead rank logs no per-step line of the history
    assert "pretrain_bert rank 1] phase1 step" not in outs[tag]
    assert "pretrain_bert rank 0] phase1 step" in outs[tag]


def test_crash_then_resume_at_world_2_has_the_uninterrupted_bits(runs):
    tmp, outs = runs
    assert re.search(r"exitcode\s*:\s*43", outs["crash"]), outs["crash"][-3000:]
    assert "resumed from checkpoint step 10" in outs["resume"]
    assert "rank 1] resumed from checkpoint step 10" in outs["resume"]
    got, want = _lines(f"{tmp}/crash.jsonl"), _loss_log(f"{tmp}/ring.jsonl")
    # steps 1..11 before the crash, then 11 and 12 replayed and phase 2
    assert [k for k, _ in got] == LOGGED[:CRASH] + LOGGED[10:]
    for key, loss in got:
        assert loss.hex() == want[key].hex(), (key, loss, want[key])


def test_dp_at_world_1_has_the_single_process_bits(runs):
    tmp, outs = runs
    got, want = _loss_log(f"{tmp}/w1.jsonl"), _loss_log(f"{tmp}/plain.jsonl")
    assert sorted(got) == sorted(want) == sorted(LOGGED)
    for key, loss in want.items():
        assert got[key].hex() == loss.hex(), (key, got[key], loss)
    assert "dp rank 0 of 1" in outs["w1"]


def test_dp_check_holds_every_strategy(runs):
    _, outs = runs
    res = json.loads(outs["dp_check"].strip().splitlines()[-1])
    assert (res["world"], res["pods"], res["backend"], res["staged"]) == \
        (4, 2, "gloo", False)
    assert sorted(res["strategies"]) == sorted(
        ("psum", "ring", "hierarchical", "bucketed"))
    for strategy, rec in res["strategies"].items():
        assert rec["digests_equal"] and rec["loss_vs_psum"] <= 1e-5, strategy
        assert len(rec["ranks"]) == 4
        assert all(r["vs_psum"]["outside_tol"] == 0 for r in rec["ranks"])
        assert all(r["exchange_s"] > 0 for r in rec["ranks"])
        assert rec["exchange_bytes"] == 1.5 * 4 * rec["n_params"]
