"""The port's data-parallel train step against the reference's for
bucketed (a (4,) ``("data",)`` mesh, 6 buckets of 2**16 bytes) and
hierarchical (a (2, 2) ``("pod", "data")`` mesh; the port's 4 ranks in 2
pods), as ``tests/test_torch_dp.py`` holds psum and ring (see there)."""
import pytest

from test_torch_dp import (check_against_reference, check_agrees_with_psum,
                           check_every_rank_the_same, reference_params)

import torch_dp_workers as W
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

STRATEGIES = ("bucketed", "hierarchical")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return W.run_dp(tmp_path_factory.mktemp("dp_hier"), reference_params(),
                    W.dp_batch(5), STRATEGIES, ("psum",) + STRATEGIES,
                    extras=False)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dp_step_matches_the_reference(runs, strategy):
    ref, port, _ = runs
    check_against_reference(ref, port, strategy)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_every_rank_holds_the_same_state(runs, strategy):
    check_every_rank_the_same(runs[1], strategy)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_agrees_with_psum(runs, strategy):
    check_agrees_with_psum(runs[1], strategy)
