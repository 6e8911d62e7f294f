"""The supervised loop (``train/trainer.py`` ``train_loop``) under data
parallelism, on 2 gloo ranks whose step all-reduces a counter
(``tests/torch_dp_workers.py`` ``loop_rank``):

* a ``RuntimeError`` raised on one rank after the step's exchange ends the
  run on both ranks, not retried: a retry would pair that rank's
  all-reduce with its peer's next step's and both would carry on from
  states one step apart;
* a ``TransientStepError`` injected on every rank at the same step
  (``REPRO_FAULTS``' ``fail_at``) is retried on every rank and the run ends
  with the uninterrupted counter;
* ranks that resume from one shared checkpoint directory go on together;
  ranks that find different checkpoints raise before any step.

Each case is one spawn with a 15 s collective timeout and a 120 s limit."""
import json

import pytest

from repro_torch.launch import mesh as M

import torch_dp_workers as W
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

WORLD = 2


def run(tmp_path, case):
    M.spawn(W.loop_rank, WORLD, args=(case, str(tmp_path)), device="cpu",
            timeout_s=15, wait_s=120)
    return [json.loads((tmp_path / f"{case}_rank{r}.json").read_text())
            for r in range(WORLD)]


def test_an_error_on_one_rank_after_the_exchange_ends_the_run(tmp_path):
    failing, peer = reversed(run(tmp_path, "one_rank_error"))
    assert failing["error"] == \
        "RuntimeError: rank 1 fails after the exchange"
    # the peer stops in the next step's all-reduce, its partner gone
    assert peer["error"] is not None and "w" not in peer


def test_a_fault_on_every_rank_is_retried_on_every_rank(tmp_path):
    for r, res in enumerate(run(tmp_path, "transient_everywhere")):
        assert res["error"] is None, (r, res)
        assert (res["w"], res["retries"]) == (WORLD * W.LOOP_STEPS, 1)
        assert res["steps"] == list(range(1, W.LOOP_STEPS + 1))


@pytest.mark.parametrize("case,same", [("resume_shared", True),
                                       ("resume_apart", False)])
def test_ranks_resume_only_from_the_same_checkpoint(tmp_path, case, same):
    for r, res in enumerate(run(tmp_path, case)):
        if same:
            assert res["error"] is None, (r, res)
            # 4 from the checkpoint of step 2, then steps 3 and 4
            assert (res["w"], res["steps"]) == (4.0 + 2 * WORLD, [3, 4])
        else:
            assert res["error"].startswith(
                "RuntimeError: data-parallel ranks resumed from different "
                "checkpoints (steps [2, 0]"), (r, res)
