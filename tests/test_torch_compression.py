"""The port's compressed gradient exchange (``repro_torch/core/
collectives.py``: ``quantize_int8``, ``int8_two_stage_all_reduce``,
``compressed_reduce_gradients``) against the reference's, twins of
``tests/test_compression.py``.

* the quantiser on seeded numpy input: the reference's int8 values and
  scale in bits, the bounds of ``:25`` and the zero input of ``:37``;
* ``GRAD_COMPRESSIONS`` and the config of ``:44``; the single-card step's
  refusal (``:89``, the twin of ``make_train_step_gspmd``'s);
* ``:109`` and ``:147`` at 4 gloo ranks in 2 pods: fp16 under psum, ring,
  hierarchical and bucketed, int8 under psum, bucketed and hierarchical
  (several buckets, one bucket), and a rank whose gradient is NaN, each
  held against the reference's ``compressed_reduce_gradients`` over 4
  forced host devices on the same inputs (``torch_dp_workers.
  run_compression``): the flag, the residual and the int8 sum in bits;
  the fp16 sum in bits under the ring (the port adds the chunks in the
  reference's order) and within the reference test's fp16 tolerance under
  the all-reduces (gloo sums the 4 fp16 rows in an order of its own, and
  XLA in another); every sum within the reference test's tolerance of the
  true sum.  The int8 bits need the reference's arithmetic: its jitted
  XLA fuses each dequantise into the add or subtract after it (one
  rounding; ``collectives._fma``), and with pods it orders its devices
  data-major (``DPMesh.exchange_order``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import collectives as JC
from repro_torch.configs import TrainConfig
from repro_torch.core import collectives as C
from repro_torch.core.amp import make_policy
from repro_torch.models import api
from repro_torch.train import train_step as ts

import torch_dp_workers as W

SUM_TOL = {"fp16": 1e-3, "int8": 5e-2}      # tests/test_compression.py:103


def _quantize_both(x: np.ndarray):
    q, scale = C.quantize_int8(torch.from_numpy(x))
    jq, jscale = JC.quantize_int8(x)
    return q, scale, np.asarray(jq), np.asarray(jscale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_bounds_and_error(seed):
    x = (np.random.default_rng(seed).standard_normal(513) * 3.0).astype(
        np.float32)
    q, scale, jq, jscale = _quantize_both(x)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    assert scale.numpy().tobytes() == jscale.tobytes()
    assert int(q.abs().max()) <= 127
    np.testing.assert_allclose(float(scale), float(np.abs(x).max()) / 127.0,
                               rtol=1e-6)
    deq = C.dequantize_int8(q, scale)
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(JC.dequantize_int8(jq, jscale)))
    assert float((deq - torch.from_numpy(x)).abs().max()) <= \
        float(scale) / 2 + 1e-7


def test_quantize_int8_rounds_half_to_even():
    """absmax 127 makes the scale 1, so x / scale is exact: 0.5, 1.5, 2.5
    and -2.5 round to even, as ``jnp.round``."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -2.5, 3.5], np.float32)
    q, scale, jq, _ = _quantize_both(x)
    assert float(scale) == 1.0
    assert q.tolist() == jq.tolist() == [127, 0, 2, 2, -2, 4]


def test_quantize_int8_zero_input_is_safe():
    q, scale, jq, jscale = _quantize_both(np.zeros(16, np.float32))
    assert float(scale) > 0 and scale.numpy().tobytes() == jscale.tobytes()
    assert q.tolist() == jq.tolist() == [0] * 16
    np.testing.assert_array_equal(C.dequantize_int8(q, scale).numpy(), 0.0)


def test_grad_compression_config_values():
    assert C.GRAD_COMPRESSIONS == JC.GRAD_COMPRESSIONS == ("none", "fp16",
                                                            "int8")
    assert TrainConfig().grad_compression == "none"
    for comp in C.GRAD_COMPRESSIONS:
        for overlap in (False, True):
            TrainConfig(grad_compression=comp,
                        overlap_exchange=overlap).check_supported()
    with pytest.raises(ValueError, match="unknown gradient compression"):
        TrainConfig(grad_compression="int4").check_supported()
    assert dataclasses.asdict(TrainConfig(grad_compression="int8")) == \
        dataclasses.asdict(JTrainConfig(grad_compression="int8"))


@pytest.mark.parametrize("kw,name", [
    (dict(grad_compression="fp16"), "grad_compression"),
    (dict(grad_compression="int8"), "grad_compression"),
    (dict(overlap_exchange=True), "overlap_exchange")])
def test_single_card_step_refuses_compression_and_overlap(kw, name):
    """The single-card step has no exchange to compress or overlap: it
    names ``make_train_step_dp`` (the twin of the reference's GSPMD
    step's refusals)."""
    tcfg = TrainConfig(precision="f32", accum_steps=1, **kw)
    pol = make_policy("f32")
    state = ts.init_train_state(api.init_params(W.DP_CFG, seed=0,
                                                device="cpu"), pol, tcfg,
                                cfg=W.DP_CFG)
    batch = api.to_device(W.dp_batch(0), "cpu")
    with pytest.raises(ValueError, match=name) as got:
        ts.train_step_fn(state, batch, cfg=W.DP_CFG, tcfg=tcfg, policy=pol)
    assert "make_train_step_dp" in str(got.value)
    assert state.opt.step == 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = W.compression_inputs(109)
    ref, port = W.run_compression(tmp_path_factory.mktemp("comp"), data)
    return data, ref, port


CASES = sorted(W.COMP_CASES)
FINITE = [c for c in CASES if not c.endswith("nonfinite")]


@pytest.mark.parametrize("case", CASES)
def test_flag_and_residual_match_the_reference(runs, case):
    _, ref, port = runs
    for r, got in enumerate(port):
        assert bool(got[f"{case}/fin"]) == bool(ref[f"{case}/fin"]) == \
            (case in FINITE), (case, r)
        for k in W.COMP_LEAVES:
            np.testing.assert_array_equal(got[f"{case}/err/{k}"],
                                          ref[f"{case}/err/{k}"][r],
                                          err_msg=f"{case} rank {r} {k}")


@pytest.mark.parametrize("case", CASES)
def test_sum_matches_the_reference(runs, case):
    """int8 over the flat mesh and the fp16 ring in bits; the fp16
    all-reduces within the reference test's fp16 tolerance (1e-3, relative
    and of the largest sum): gloo and XLA each add the 4 fp16 rows in an
    order of their own, each add rounding to fp16.  int8 over 2 pods
    within one quantum of the final scale: there the reference's XLA
    computes a shard's sum twice, in the absmax's fusion and in the
    quantiser's, and fuses the two differently, so a shard's scale can
    come out one ulp off the one its own sum gives."""
    _, ref, port = runs
    mode, strategy, _ = W.COMP_CASES[case]
    pods = mode == "int8" and strategy == "hierarchical"
    bits = (mode == "int8" and not pods) or strategy == "ring" or \
        case.endswith("nonfinite")
    for r, got in enumerate(port):
        peak = max(np.abs(ref[f"{case}/red/{k}"]).max() for k in W.COMP_LEAVES)
        for k in W.COMP_LEAVES:
            want = ref[f"{case}/red/{k}"][r]
            if bits:
                np.testing.assert_array_equal(got[f"{case}/red/{k}"], want,
                                              err_msg=f"{case} rank {r} {k}")
            elif pods:
                quantum = np.abs(ref[f"{case}/red/{k}"]).max() / 127
                np.testing.assert_allclose(got[f"{case}/red/{k}"], want,
                                           rtol=0, atol=quantum,
                                           err_msg=f"{case} rank {r} {k}")
            else:
                np.testing.assert_allclose(got[f"{case}/red/{k}"], want,
                                           rtol=SUM_TOL[mode],
                                           atol=SUM_TOL[mode] * peak,
                                           err_msg=f"{case} rank {r} {k}")
        # every rank holds the same sum
        for k in W.COMP_LEAVES:
            np.testing.assert_array_equal(got[f"{case}/red/{k}"],
                                          port[0][f"{case}/red/{k}"])


@pytest.mark.parametrize("case", CASES)
def test_every_sum_is_a_buffer_the_optimizer_takes(runs, case):
    """Contiguous and 16-byte aligned (``csrc/lamb_update.cu``'s wrapper
    refuses anything else), also where a bucket of several buffers was
    summed as one."""
    _, _, port = runs
    assert all(bool(got[f"{case}/aligned"]) for got in port)


@pytest.mark.parametrize("case", FINITE)
def test_sum_is_near_the_true_sum_and_the_residual_is_the_error(runs, case):
    """``:109``: the compressed sum within the reference test's tolerance
    of the sum of the inputs plus residuals; the fp16 residual is exactly
    what the cast to fp16 dropped, and nonzero."""
    data, _, port = runs
    mode = W.COMP_CASES[case][0]
    for k in W.COMP_LEAVES:
        x = data[f"{case}/g/{k}"] + data[f"{case}/e/{k}"]
        want = x.sum(0)
        tol = SUM_TOL[mode]
        np.testing.assert_allclose(port[0][f"{case}/red/{k}"], want,
                                   rtol=tol, atol=tol * np.abs(want).max(),
                                   err_msg=f"{case} {k}")
        for r, got in enumerate(port):
            if mode == "fp16":
                np.testing.assert_array_equal(
                    got[f"{case}/err/{k}"],
                    x[r] - x[r].astype(np.float16).astype(np.float32))
            assert np.abs(got[f"{case}/err/{k}"]).max() > 0, (case, r, k)


@pytest.mark.parametrize("case", ["int8_nonfinite", "fp16_nonfinite"])
def test_nonfinite_rank_holds_every_residual(runs, case):
    """``:147``: rank 2's NaN makes the flag False on every rank, the sum
    stays finite (zeros plus the residuals) and every residual is held."""
    data, _, port = runs
    for r, got in enumerate(port):
        assert not bool(got[f"{case}/fin"])
        for k in W.COMP_LEAVES:
            assert np.all(np.isfinite(got[f"{case}/red/{k}"]))
            np.testing.assert_array_equal(got[f"{case}/err/{k}"],
                                          data[f"{case}/e/{k}"][r])
