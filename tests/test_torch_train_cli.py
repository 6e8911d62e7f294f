"""The decoder trainer's CLI, ``python -m repro_torch.launch.train
--device cpu``, on the smoke deepseek-7b:

* the twin of ``tests/test_cli.py::test_train_cli_smoke`` (6 steps of
  4 x 64 tokens, accumulation 2), in process;
* the twins of ``tests/test_faults.py::test_cli_crash_resume_loss_bit_
  identical`` and ``::test_cli_torn_checkpoint_recovery`` with
  ``--optimizer adamw`` and ``lamb``: ``REPRO_FAULTS=crash_at=5`` (exit 43,
  newest checkpoint 3) or ``torn_at=6,crash_at=6`` (the torn checkpoint 6
  skipped), then ``--resume``: every logged loss has the uninterrupted
  run's float32 bits;
* the ring run of ``tests/test_cli.py::test_train_cli_dp_ring`` on four
  gloo ranks through torchrun, on deepseek-7b (the twin on the
  reference's rwkv6-1.6b is ``tests/test_torch_rwkv_train.py``).  Every
  rank ends with the same state digest and loss bits, and the ring's
  losses stay within 1e-5 of a serial run's (the ring adds in another
  order than the one process);
* ``--dp`` at world 1 with int8 compression, the overlapped drain and
  the timing breakdown, in process;
* the refusals: ``--pure-dp``, an RWKV ``--seq`` that wkv6's chunk does
  not divide, an unknown optimizer, BERT, the exchange flags without
  ``--dp``.

Every subprocess has a timeout; one that outlives it is killed with its
process group."""
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
from repro_torch.launch import train as T
from repro_torch.train.checkpoint import latest_step
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ARGS = ["--device", "cpu", "--steps", "7", "--batch", "2", "--seq", "32",
        "--precision", "f32", "--log-every", "1", "--ckpt-every", "3"]
DIGEST = re.compile(r"\[INFO repro_torch.train rank (\d)\] dp rank \d of "
                    r"(\d): state digest (\w+), losses (\[.*\])")


def _start(tmp, tag, extra=(), faults="", torchrun=0):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("REPRO_FAULTS", None)
    if faults:
        env["REPRO_FAULTS"] = faults
    cmd = [sys.executable, "-m", "repro_torch.launch.train"]
    if torchrun:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(torchrun), "-m",
               "repro_torch.launch.train"]
    return subprocess.Popen(
        cmd + [*ARGS, "--ckpt-dir", f"{tmp}/{tag}_ckpt", "--loss-log",
               f"{tmp}/{tag}.jsonl", *extra], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def _finish(proc, code=0):
    try:
        out, _ = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"timed out and killed:\n{out[-4000:]}")
    assert proc.returncode == code, \
        f"expected exit {code}, got {proc.returncode}:\n{out[-6000:]}"
    return out


def _loss_log(path):
    return [(r["step"], r["loss"])
            for r in map(json.loads, Path(path).read_text().splitlines())]


OPTIMIZERS = ("adamw", "lamb")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per optimizer: an uninterrupted run, a crashed one and a torn one,
    each faulted run then resumed; and a ring run on 4 gloo ranks."""
    tmp = str(tmp_path_factory.mktemp("train_cli"))
    first = {}
    for opt in OPTIMIZERS:
        kw = dict(extra=["--optimizer", opt])
        first[(opt, "ref")] = (_start(tmp, f"{opt}_ref", **kw), 0)
        first[(opt, "crash")] = (_start(tmp, f"{opt}_crash",
                                        faults="crash_at=5", **kw), 43)
        first[(opt, "torn")] = (_start(tmp, f"{opt}_torn",
                                       faults="torn_at=6,crash_at=6", **kw),
                                43)
    first[("ring", "dp")] = (_start(tmp, "ring", torchrun=4, extra=[
        "--dp", "--strategy", "ring", "--steps", "4", "--batch", "8"]), 0)
    outs = {k: _finish(p, code) for k, (p, code) in first.items()}
    latest = {(opt, tag): latest_step(f"{tmp}/{opt}_{tag}_ckpt")
              for opt in OPTIMIZERS for tag in ("crash", "torn")}
    resumed = {(opt, f"{tag}_resume"): _start(
        tmp, f"{opt}_{tag}", extra=["--optimizer", opt, "--resume"])
        for opt in OPTIMIZERS for tag in ("crash", "torn")}
    outs.update({k: _finish(p) for k, p in resumed.items()})
    return tmp, outs, latest


def test_train_cli_smoke(tmp_path):
    """Twin of ``tests/test_cli.py:7``: 6 steps of the smoke deepseek-7b,
    4 x 64 tokens in 2 micro-batches, finite losses."""
    cfg, state, history = T.run(["--arch", "deepseek-7b", "--steps", "6",
                                 "--batch", "4", "--seq", "64", "--accum",
                                 "2", "--device", "cpu", "--log-every", "1"])
    assert T.main(["--steps", "1", "--batch", "2", "--seq", "16",
                   "--device", "cpu"]) == 0
    assert (cfg.arch_id, cfg.n_layers, cfg.d_model) == ("deepseek-7b", 1, 256)
    assert state.opt.step == 6 and [r["step"] for r in history] == \
        list(range(1, 7))
    assert all(np.isfinite(r["loss"]) and not r["skipped"] for r in history)
    assert history[-1]["tokens_per_s"] > 0


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_cli_crash_resume_loss_bit_identical(runs, opt):
    """Crash after step 5 (newest checkpoint 3), resume: steps 4..7 replayed
    to the uninterrupted run's bits."""
    tmp, outs, latest = runs
    ref = dict(_loss_log(f"{tmp}/{opt}_ref.jsonl"))
    assert sorted(ref) == list(range(1, 8))
    assert latest[(opt, "crash")] == 3
    assert "resumed from checkpoint step 3" in outs[(opt, "crash_resume")]
    got = _loss_log(f"{tmp}/{opt}_crash.jsonl")
    assert [s for s, _ in got] == [1, 2, 3, 4, 5, 4, 5, 6, 7]
    for s, loss in got:
        assert loss.hex() == ref[s].hex(), (s, loss, ref[s])


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_cli_torn_checkpoint_recovery(runs, opt):
    """Checkpoint 6 torn as it is written, then a crash: the resume falls
    back to checkpoint 3 and reproduces the uninterrupted trajectory."""
    tmp, outs, latest = runs
    ref = dict(_loss_log(f"{tmp}/{opt}_ref.jsonl"))
    assert latest[(opt, "torn")] == 3
    merged = dict(_loss_log(f"{tmp}/{opt}_torn.jsonl"))
    assert sorted(merged) == list(range(1, 8))
    for s in range(1, 8):
        assert merged[s].hex() == ref[s].hex(), s


def test_the_optimizers_take_different_steps(runs):
    """The two runs share weights and batches: the first loss is the same,
    the later ones are not."""
    tmp, _, _ = runs
    adamw, lamb = (dict(_loss_log(f"{tmp}/{o}_ref.jsonl"))
                   for o in OPTIMIZERS)
    assert adamw[1] == lamb[1]
    assert adamw[7] != lamb[7]


def test_train_cli_dp_ring(runs, tmp_path):
    """Four gloo ranks through torchrun, ``--dp --strategy ring``, 4 steps
    of 8 x 32 tokens in f32: the same state digest and loss bits on every
    rank, rank 0 alone writing the loss log; the losses within 1e-5 of the
    same run in one process (world 1, no exchange)."""
    tmp, outs, _ = runs
    found = {int(m[0]): m for m in DIGEST.findall(outs[("ring", "dp")])}
    assert sorted(found) == [0, 1, 2, 3] and found[0][1] == "4"
    assert len({m[2] for m in found.values()}) == 1
    assert len({m[3] for m in found.values()}) == 1
    losses = [float.fromhex(h) for h in json.loads(found[0][3])]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert [h for h in json.loads(found[0][3])] == \
        [v.hex() for _, v in _loss_log(f"{tmp}/ring.jsonl")]
    _, _, serial = T.run(ARGS + ["--steps", "4", "--batch", "8",
                                 "--ckpt-dir", str(tmp_path)])
    np.testing.assert_allclose(losses, [r["loss"] for r in serial],
                               rtol=1e-5)


def test_dp_world_1_takes_the_exchange_options(tmp_path):
    """``--dp`` without torchrun is world 1: with ``--grad-compression
    int8 --overlap --bucket-bytes --timing-breakdown`` the state carries
    this rank's residual (nonzero after int8 rounding), every logged step
    reports ``compute_s`` and ``exchange_s`` against the twins, and every
    loss is finite."""
    _, state, history = T.run(ARGS + [
        "--steps", "3", "--dp", "--grad-compression", "int8", "--overlap",
        "--bucket-bytes", "65536", "--timing-breakdown", "--ckpt-dir",
        str(tmp_path)])
    assert state.world == 1 and state.err is not None
    assert any(float(e.abs().max()) > 0 for e in state.err.values())
    assert [r["step"] for r in history] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in history)
    assert all("compute_s" in r and "exchange_s" in r for r in history[1:])


@pytest.mark.parametrize("argv,match", [
    (["--pure-dp"], "sharding slice"),
    (["--arch", "rwkv6-1.6b", "--seq", "100"], "multiple of wkv6's"),
    (["--arch", "bert-large"], "pretrain_bert"),
    (["--grad-compression", "int8"], "requires --dp"),
    (["--overlap"], "requires --dp"),
    (["--timing-breakdown"], "requires --dp"),
    (["--full", "--layers", "0"], "positive multiple")])
def test_refusals_name_what_they_wait_for(argv, match):
    with pytest.raises(SystemExit, match=match):
        T.run(["--device", "cpu", *argv])


def test_unknown_optimizer_is_refused():
    """The reference runs AdamW for any name but "lamb"; the port raises."""
    with pytest.raises(ValueError, match="unknown optimizer 'sgd'"):
        T.run(["--device", "cpu", "--optimizer", "sgd", "--steps", "1"])
