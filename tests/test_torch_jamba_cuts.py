"""The hybrid jamba-1.5-large-398b's depth cuts and training CLI on the
port, against the JAX package where it has a twin, at ``smoke_variant``
sizes (``tests/test_torch_jamba_train.py``'s weights and helpers):

* the router's aux loss and every gradient of ``lm_train_loss`` for the
  smoke block's first 4 layers ((attn, dense), (mamba, moe), (mamba,
  dense), (mamba, moe): the aux is position 3's) and for granite's
  one-position blocks (every layer's aux), with the aux at 1.0, the
  port's recompute off and on;
* ``configs.cut_positions`` and ``launch/train.py --positions``, a depth
  cut the reference lacks, and their refusals; ``profile_train``'s jamba
  path;
* the smoke hybrid through the CLI crashed after step 2 and resumed: the
  uninterrupted run's losses in bits."""
import os
import subprocess
import sys

import pytest

from conftest import SRC
from repro_torch.configs import cut_positions, get_config
from repro_torch.launch import profile_train
from repro_torch.launch import train as train_cli
from repro_torch.train.checkpoint import latest_step
from test_torch_jamba_train import GRANITE, check_loss_and_gradients
from test_torch_train_cli import _finish, _loss_log
from torch_jamba import ARCH
import torch_threads  # noqa: F401  (one PyTorch thread a worker)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", ["jamba-4", GRANITE])
def test_router_aux_and_every_gradient_match_the_reference(case, remat):
    """``check_loss_and_gradients`` of the 4-layer cut and granite."""
    check_loss_and_gradients(case, remat)


# ---------------------------------------------------------------------------
# the cut and the CLI
# ---------------------------------------------------------------------------

def test_cut_positions_keeps_the_widths():
    """``cut_positions(jamba, (2,))`` is its (mamba, dense) layer alone at
    full width: 1 layer, 2.098 B parameters with the embedding and the
    head; (0, 2) is (attn, dense) then (mamba, dense); an empty,
    repeated, unordered or out-of-range list raises."""
    full = get_config(ARCH)
    cfg = cut_positions(full, (2,))
    assert cfg.block_pattern == (("mamba", "dense"),) and cfg.n_layers == 1
    assert (cfg.d_model, cfg.mamba_d_inner, cfg.d_ff, cfg.vocab_size) == (
        full.d_model, full.mamba_d_inner, full.d_ff, full.vocab_size)
    assert round(cfg.param_count() / 1e9, 3) == 2.098
    assert not cfg.has_moe
    two = cut_positions(full, (0, 2))
    assert two.block_pattern == (("attn", "dense"), ("mamba", "dense"))
    for bad in ((), (2, 2), (3, 1), (8,), (-1,)):
        with pytest.raises(ValueError, match="positions"):
            cut_positions(full, bad)


@pytest.mark.parametrize("argv,match", [
    (["--full", "--positions", "2", "--layers", "1"], "two depth cuts"),
    (["--positions", "2"], "needs --full"),
    (["--full", "--positions", "two"], "comma list"),
    (["--full", "--positions", "9"], "positions"),
])
def test_positions_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        train_cli.model_config(train_cli.parse_args(["--arch", ARCH, *argv]))


def test_the_cli_takes_positions_and_profile_train_has_the_path():
    """``--full --positions 2`` gives the cut's config (not built here:
    2.1 B parameters); ``LM_PATHS`` holds jamba's path as positions (2,)
    at 8 x 1024 in 2 micro-batches, which ``depth_flags`` turns into the
    CLI's flag; ``profile_train`` refuses ``--positions`` without
    ``--full-width``."""
    cfg = train_cli.model_config(train_cli.parse_args(
        ["--arch", ARCH, "--full", "--positions", "2"]))
    assert cfg == cut_positions(get_config(ARCH), (2,))
    assert profile_train.LM_PATHS[ARCH] == ((2,), 8, 1024, 2)
    assert profile_train.depth_flags((2,)) == ["--positions", "2"]
    assert profile_train.depth_flags(4) == ["--layers", "4"]
    with pytest.raises(SystemExit, match="--full-width"):
        profile_train.main(["--arch", ARCH, "--positions", "2"])


CLI = ["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch", "2",
       "--seq", "16", "--precision", "f32", "--log-every", "1",
       "--ckpt-every", "1"]


def _cli(tmp, tag, faults="", extra=()):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("REPRO_FAULTS", None)
    if faults:
        env["REPRO_FAULTS"] = faults
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI,
         "--ckpt-dir", f"{tmp}/{tag}_ckpt", "--loss-log",
         f"{tmp}/{tag}.jsonl", *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


def test_cli_crash_resume_in_bits(tmp_path):
    """The smoke hybrid through ``launch/train.py`` (LAMB, router aux
    logged): 2 steps uninterrupted, and crashed after step 2
    (``REPRO_FAULTS=crash_at=2``, exit 43, newest checkpoint 1) then
    ``--resume``d: the replayed step 2 has the uninterrupted loss's
    bits."""
    ref, crash = _cli(tmp_path, "ref"), _cli(tmp_path, "crash",
                                              "crash_at=2")
    out = _finish(ref)
    _finish(crash, 43)
    assert "router aux" in out
    assert latest_step(f"{tmp_path}/crash_ckpt") == 1
    resumed = _finish(_cli(tmp_path, "crash", extra=["--resume"]))
    assert "resumed from checkpoint step 1" in resumed
    want = dict(_loss_log(f"{tmp_path}/ref.jsonl"))
    got = _loss_log(f"{tmp_path}/crash.jsonl")
    assert [s for s, _ in got] == [1, 2, 2]
    for s, loss in got:
        assert loss.hex() == want[s].hex(), (s, loss, want[s])
