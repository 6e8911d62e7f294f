"""The compressed exchange, the overlapped drain and the timing breakdown
through the real CLI: ``python -m torch.distributed.run --standalone
--nproc-per-node 2 -m repro_torch.launch.pretrain_bert --device cpu --dp
--grad-compression int8 --overlap --timing-breakdown`` on gloo, at 2
layers and d_model 32 (4 phase-1 steps with checkpoints at 3 and 4
(``--ckpt-every 3``), 1 phase-2 step, every loss logged).

* ``--grad-compression``, ``--overlap`` and ``--timing-breakdown`` are
  refused without ``--dp``;
* the run logs the timing calibration of each phase and, in each logged
  phase-1 step after the first, ``compute_s``, ``exchange_s`` and
  ``overlap_frac``; both ranks end with the same state digest and loss
  bits and residuals of their own;
* its checkpoints hold the residual group, a (2, ...) leaf of every rank's
  rows;
* ``REPRO_FAULTS=crash_at=4`` (after the checkpoint of step 3, which holds
  a nonzero residual) then ``--resume`` gives the uninterrupted run's
  losses in bits.

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
from repro_torch.launch import pretrain_bert
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

FLAGS = ["--grad-compression", "int8", "--overlap", "--timing-breakdown"]
LOGGED = [("phase1", s) for s in range(1, 5)] + [("phase2", 1)]
DIGEST = re.compile(r"\[INFO repro_torch.pretrain_bert rank (\d)\] dp rank "
                    r"\d of 2: (state|residual) digest (\w+)")


@pytest.mark.parametrize("flag", [["--grad-compression", "fp16"],
                                  ["--overlap"], ["--timing-breakdown"]])
def test_the_flags_are_refused_without_dp(flag):
    with pytest.raises(SystemExit, match="requires --dp"):
        pretrain_bert.parse_args(["--device", "cpu", *flag])
    pretrain_bert.parse_args(["--device", "cpu", "--dp", *flag])


@pytest.mark.parametrize("argv", [["--layers", "4"],
                                  ["--full-width", "--layers", "0"]])
def test_the_depth_cut_takes_full_width_only(argv):
    """``--layers N`` (the compressed data-parallel check's depth cut) is
    bert-large's width at N layers: refused without ``--full-width`` or
    below one layer."""
    with pytest.raises(SystemExit, match="--layers takes a positive depth"):
        pretrain_bert.parse_args(["--device", "cpu", *argv])
    assert pretrain_bert.parse_args(
        ["--device", "cpu", "--full-width", "--layers", "4"]).layers == 4


def _cli(tmp, tag, faults="", resume=False):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("REPRO_FAULTS", None)
    if faults:
        env["REPRO_FAULTS"] = faults
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.pretrain_bert",
           "--dp", "--device", "cpu", "--steps", "5", "--batch", "8",
           "--accum", "2", "--d-model", "32", "--ckpt-every", "3",
           "--workdir", f"{tmp}/{tag}", "--loss-log", f"{tmp}/{tag}.jsonl",
           *FLAGS] + (["--resume"] if resume else [])
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
    return [((r["phase"], r["step"]), r["loss"])
            for r in map(json.loads, Path(path).read_text().splitlines())]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("comp_cli"))
    procs = {"whole": _cli(tmp, "whole"),
             "crash": _cli(tmp, "crash", faults="crash_at=4")}
    outs = {k: _finish(p, ok=k != "crash") for k, p in procs.items()}
    outs["resume"] = _finish(_cli(tmp, "crash", resume=True))
    return tmp, outs


def test_the_timing_breakdown_is_logged(runs):
    _, outs = runs
    out = outs["whole"]
    for phase in ("phase1", "phase2"):
        assert re.search(rf"rank 0\] {phase} timing calibration: compute "
                         r"[\d.]+ ms \| serial step [\d.]+ ms", out), phase
    steps = re.findall(r"rank 0\] phase1 step (\d): .*; compute_s ([\d.]+), "
                       r"exchange_s ([\d.]+), overlap_frac (\S+)", out)
    assert [int(s[0]) for s in steps] == [2, 3, 4]
    assert all(float(s[1]) > 0 for s in steps)


def test_both_ranks_end_with_one_state_and_their_own_residuals(runs):
    _, outs = runs
    found = {(int(r), kind): d for r, kind, d in
             DIGEST.findall(outs["whole"])}
    assert found[(0, "state")] == found[(1, "state")]
    assert found[(0, "residual")] != found[(1, "residual")]


def test_the_checkpoints_hold_every_ranks_residual(runs):
    tmp, outs = runs
    for d in ("whole", "crash"):
        man = json.loads(Path(f"{tmp}/{d}/ckpt/phase1/ckpt_00000003.json")
                         .read_text())
        err = [(n, s) for n, s in zip(man["names"], man["shapes"])
               if n.startswith("err/")]
        assert len(err) == 26 and all(s[0] == 2 for _, s in err)
        with np.load(f"{tmp}/{d}/ckpt/phase1/ckpt_00000003.npz") as z:
            rows = z[f"a{man['names'].index(err[0][0]):06d}"]
        assert np.abs(rows).max() > 0 and not np.array_equal(rows[0],
                                                             rows[1])
    assert "rank 0] checkpoint step 3 saved" in outs["whole"]


def test_crash_then_resume_has_the_uninterrupted_bits(runs):
    tmp, outs = runs
    assert re.search(r"exitcode\s*:\s*43", outs["crash"]), \
        outs["crash"][-3000:]
    assert "rank 1] resumed from checkpoint step 3" in outs["resume"]
    want = dict(_lines(f"{tmp}/whole.jsonl"))
    got = _lines(f"{tmp}/crash.jsonl")
    assert sorted(want) == sorted(LOGGED)
    # steps 1..4 before the crash, then 4 replayed and phase 2
    assert [k for k, _ in got] == LOGGED[:4] + LOGGED[3:]
    for key, loss in got:
        assert loss.hex() == want[key].hex(), (key, loss, want[key])


def test_loop_launches_leave_out_the_calibration(tmp_path, monkeypatch,
                                                 caplog):
    """The closing ``kernel launches`` line counts the training loop's
    steps alone: the timing calibration's twins (2 x 4 steps a phase) run
    in the same process before it and are left out.  No kernel launches on
    the CPU, so a stand-in count that rises by one a step shows it.  The
    run (world 1, ``--strategy bucketed --overlap``) also logs the last
    step's buckets, every one started from the backward's hooks."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    steps = {"n": 0}
    real = pretrain_bert.make_train_step_dp

    def counted(*a, **k):
        step = real(*a, **k)

        def wrapped(state, batch):
            steps["n"] += 1
            return step(state, batch)
        wrapped.__dict__ = step.__dict__   # the step's attributes, shared
        return wrapped
    monkeypatch.setattr(pretrain_bert, "make_train_step_dp", counted)
    monkeypatch.setattr(pretrain_bert.ops, "launch_counts",
                        lambda: {"flash_fwd": steps["n"]})
    caplog.set_level("INFO", logger="repro_torch")
    pretrain_bert.run(["--dp", "--device", "cpu", "--steps", "3", "--batch",
                       "8", "--accum", "2", "--d-model", "32", "--precision",
                       "f32", "--strategy", "bucketed", "--overlap",
                       "--bucket-bytes", "100000", "--timing-breakdown",
                       "--workdir", str(tmp_path / "w")])
    assert steps["n"] == 3 + 2 * 4
    launches = re.search(r"kernel launches (\{.*\})", caplog.text)
    assert json.loads(launches[1]) == {"flash_fwd": 3}
    order = re.search(r"started buckets (\[[\d, ]*\]) of (\d+) during the "
                      r"backward", caplog.text)
    assert int(order[2]) > 1
    assert sorted(json.loads(order[1])) == list(range(int(order[2])))
