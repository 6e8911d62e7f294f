"""The port's fault-tolerant training runtime (``repro_torch.train``
``checkpoint``, ``faults``, ``trainer``) against ``repro.train``: twins of
``tests/test_faults.py`` -- atomic, verifiable checkpoints, the loader
cursor, the supervised loop (exact resume, torn-checkpoint fallback, the
non-finite budget, retry, the watchdog), the f16 overflow skip -- and two
crash -> ``--resume`` runs of ``python -m repro_torch.launch.pretrain_bert``
with ``REPRO_FAULTS`` in subprocesses, whose losses must equal an
uninterrupted run's bit for bit.

Also: checkpoints are interchangeable with the reference's in both
directions, bit for bit, and a training step that raises part-way through
the optimizer update leaves the ``TrainState`` as it was.

Left out of the twins: the two serving deadline-eviction tests (serving,
not the runtime).  The ``LMStream`` cursor test's twin is in
``tests/test_torch_lm_data.py``, and the decoder trainer's crash ->
``--resume`` runs are in ``tests/test_torch_train_cli.py``."""
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import amp as jamp
from repro.data import pipeline as jpipe
from repro.models import api as japi
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.configs.base import InputShape
from repro_torch.core import amp
from repro_torch.data.pipeline import ShardedLoader, prepare_bert_data
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.train import train_step as ts
from repro_torch.train.checkpoint import (latest_step, load_manifest,
                                          restore_checkpoint, save_checkpoint,
                                          validate_checkpoint)
from repro_torch.train.faults import (FaultInjector, FaultPlan,
                                      TransientStepError, torn_write)
from repro_torch.train.trainer import NonFiniteBudgetError, train_loop
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

REPO = Path(__file__).resolve().parent.parent
D_MODEL = 64
JCFG = jsmoke(jget_config("bert-large"), d_model=D_MODEL, n_blocks=2)
CFG = smoke_variant(get_config("bert-large"), d_model=D_MODEL, n_blocks=2)


# ---------------------------------------------------------------------------
# Atomic, verifiable checkpoints
# ---------------------------------------------------------------------------

def _tree(v: float):
    return {"w": np.full((8,), v, np.float32),
            "b": np.full((2, 3), v + 1, np.float32)}


def test_save_is_atomic_and_validates(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1.0), extra={"cursor": 7})
    assert not list(tmp_path.glob("*.tmp"))  # no temp residue
    assert validate_checkpoint(d, 1)
    man = load_manifest(d, 1)
    assert man["format"] == 2 and man["extra"]["cursor"] == 7
    assert len(man["checksums"]) == len(man["names"]) == 2
    assert man["names"] == ["b", "w"]    # sorted keys, as jax flattens


def test_torn_write_falls_back_to_previous_valid(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1.0))
    p2 = save_checkpoint(d, 2, _tree(2.0))
    assert latest_step(d) == 2
    torn_write(p2, 64)  # truncated npz, manifest intact
    assert not validate_checkpoint(d, 2)
    assert latest_step(d) == 1
    got, step = restore_checkpoint(d, _tree(0.0))
    assert step == 1
    np.testing.assert_array_equal(got["w"], _tree(1.0)["w"])
    with pytest.raises(ValueError):   # an explicit bad step is an error
        restore_checkpoint(d, _tree(0.0), step=2)


def test_checksum_detects_bitflip(tmp_path):
    d = str(tmp_path)
    p = save_checkpoint(d, 3, _tree(3.0))
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0xFF  # silent corruption, size unchanged
    p.write_bytes(bytes(raw))
    assert not validate_checkpoint(d, 3)
    assert not jckpt.validate_checkpoint(d, 3)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, _tree(0.0))  # no valid checkpoint left


def test_no_checkpoint_raises_filenotfound(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), _tree(0.0))


def test_retention_keeps_newest_valid(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        save_checkpoint(d, s, _tree(float(s)), keep=3)
    steps = sorted(int(p[-12:-4]) for p in glob.glob(d + "/ckpt_*.npz"))
    assert steps == [3, 4, 5]


def test_generic_trees_restore_in_kind_and_match_the_reference(tmp_path):
    """Tensors come back as tensors, numpy leaves as numpy, named tuples
    by field; the reference restores the port's file to the same values
    and names it the same."""
    tree = {"t": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "ls": amp.LossScaleState(2.0 ** 10, 3, 1),
            "n": [np.int32(4), np.ones(2, np.float64)], "none": None}
    d = str(tmp_path)
    save_checkpoint(d, 1, tree)
    got, _ = restore_checkpoint(d, tree)
    assert torch.equal(got["t"], tree["t"]) and got["none"] is None
    assert got["ls"] == tree["ls"] and isinstance(got["ls"],
                                                  amp.LossScaleState)
    assert got["n"][0] == 4 and got["n"][1].dtype == np.float64
    names = load_manifest(d, 1)["names"]
    assert names == ["ls/scale", "ls/good_steps", "ls/total_skipped", "n/0",
                     "n/1", "t"]
    like = {"t": np.zeros((2, 3), np.float32),
            "ls": jamp.LossScaleState(np.float32(0), np.int32(0),
                                      np.int32(0)),
            "n": [np.int32(0), np.zeros(2, np.float32)], "none": None}
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, like)
    assert load_manifest(str(tmp_path / "ref"), 1)["names"] == names
    ref, _ = jckpt.restore_checkpoint(d, like)
    np.testing.assert_array_equal(np.asarray(ref["t"]), tree["t"].numpy())
    assert float(ref["ls"].scale) == 2.0 ** 10


# ---------------------------------------------------------------------------
# Resumable data pipeline (the port's ShardedLoader, held to the reference's)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    prepare_bert_data(str(d), seq_len=64, n_docs=40, vocab_size=512,
                      n_shards=2, seed=0)
    return str(d)


def test_sharded_loader_cursor_exact_resume(shard_dir):
    ref = ShardedLoader(shard_dir, 0, 1, batch=4, seed=3)
    jref = jpipe.ShardedLoader(shard_dir, 0, 1, batch=4, seed=3)
    # advance past an epoch boundary so epoch/offset/shuffle all matter
    for _ in range(ref.batches_per_epoch + 3):
        next(ref), next(jref)
    cursor = ref.state_dict()
    assert cursor == jref.state_dict()
    want = [next(ref)["tokens"] for _ in range(5)]

    fresh = ShardedLoader(shard_dir, 0, 1, batch=4, seed=3)
    fresh.load_state_dict(cursor)
    got = [next(fresh)["tokens"] for _ in range(5)]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_sharded_loader_rejects_foreign_cursor(shard_dir):
    foreign = {"epoch": 0, "offset": 0, "seed": 99, "worker": 0}
    ld = ShardedLoader(shard_dir, 0, 1, batch=4, seed=3)
    with pytest.raises(ValueError) as got:
        ld.load_state_dict(foreign)
    with pytest.raises(ValueError) as want:
        jpipe.ShardedLoader(shard_dir, 0, 1, batch=4,
                            seed=3).load_state_dict(foreign)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Supervised train loop (dummy deterministic step: fast, exact)
# ---------------------------------------------------------------------------

def _dummy_step(state, batch):
    s = {"w": state["w"] + batch["tokens"].astype(np.float32).mean()}
    return s, {"loss": float(s["w"].sum()), "skipped": False}


def _losses(hist):
    return [h["loss"] for h in hist]


def _stream(shard_dir):
    return ShardedLoader(shard_dir, 0, 1, batch=2, seed=0)


def _w():
    return {"w": np.zeros(3, np.float32)}


def test_trainer_crash_resume_bit_exact(tmp_path, shard_dir):
    _, ref = train_loop(_dummy_step, _w(), _stream(shard_dir), total_steps=9,
                        log_every=1)
    d = str(tmp_path)
    # "crash" after 5 steps (checkpoints at 3 and the final at 5)
    train_loop(_dummy_step, _w(), _stream(shard_dir), total_steps=5,
               log_every=1, ckpt_dir=d, ckpt_every=3)
    _, hist = train_loop(_dummy_step, _w(), _stream(shard_dir),
                         total_steps=9, log_every=1, ckpt_dir=d,
                         ckpt_every=3, resume=True)
    assert _losses(hist) == _losses(ref)[5:]  # bit-identical continuation


def test_trainer_torn_latest_resumes_from_previous(tmp_path, shard_dir,
                                                   caplog):
    d = str(tmp_path)
    _, ref = train_loop(_dummy_step, _w(), _stream(shard_dir), total_steps=9,
                        log_every=1, ckpt_dir=d, ckpt_every=3)
    torn_write(Path(max(glob.glob(d + "/ckpt_*.npz"))), 32)
    with caplog.at_level("WARNING", logger="repro_torch"):
        _, hist = train_loop(_dummy_step, _w(), _stream(shard_dir),
                             total_steps=9, log_every=1, ckpt_dir=d,
                             ckpt_every=3, resume=True)
    assert any("corrupt" in r.message for r in caplog.records)  # loud, not
    #                                            a silent restart from 0
    assert _losses(hist)[-1] == _losses(ref)[-1]


def test_trainer_fresh_start_only_when_no_checkpoint(tmp_path, shard_dir,
                                                     caplog):
    with caplog.at_level("INFO", logger="repro_torch"):
        _, hist = train_loop(_dummy_step, _w(), _stream(shard_dir),
                             total_steps=3, log_every=1,
                             ckpt_dir=str(tmp_path), resume=True)
    assert any("starting fresh" in r.message for r in caplog.records)
    assert len(hist) == 3


def test_nan_skip_budget_aborts(tmp_path, shard_dir):
    inj = FaultInjector(FaultPlan(nan_at=3, nan_count=5))
    with pytest.raises(NonFiniteBudgetError):
        train_loop(_dummy_step, _w(), _stream(shard_dir), total_steps=9,
                   log_every=1, max_consecutive_skips=2, faults=inj,
                   ckpt_dir=str(tmp_path))
    # the abort left an emergency checkpoint of the last good state
    step = latest_step(str(tmp_path))
    assert step is not None
    assert load_manifest(str(tmp_path), step)["extra"]["emergency"] is True


def test_nan_skips_within_budget_surface_as_metrics(shard_dir):
    inj = FaultInjector(FaultPlan(nan_at=2, nan_count=2))
    _, hist = train_loop(_dummy_step, _w(), _stream(shard_dir),
                         total_steps=6, log_every=1,
                         max_consecutive_skips=5, faults=inj)
    assert hist[-1]["total_skips"] == 2
    assert hist[-1]["consecutive_skips"] == 0  # recovered
    assert hist[2]["consecutive_skips"] == 2   # at the injection peak


def test_transient_failure_retry_then_success(shard_dir):
    inj = FaultInjector(FaultPlan(fail_at=2, fail_count=2))
    _, hist = train_loop(_dummy_step, _w(), _stream(shard_dir),
                         total_steps=4, log_every=1, faults=inj,
                         max_retries=2, retry_backoff_s=0.0)
    assert hist[-1]["retries"] == 2
    assert len(hist) == 4  # run completed despite the failures


def test_transient_failure_exhausts_retries(tmp_path, shard_dir):
    inj = FaultInjector(FaultPlan(fail_at=2, fail_count=5))
    with pytest.raises(TransientStepError):
        train_loop(_dummy_step, _w(), _stream(shard_dir), total_steps=4,
                   log_every=1, faults=inj, max_retries=1,
                   retry_backoff_s=0.0, ckpt_dir=str(tmp_path))
    assert latest_step(str(tmp_path)) == 1  # emergency ckpt at last good


def test_watchdog_flags_injected_slow_step(shard_dir):
    inj = FaultInjector(FaultPlan(slow_at=5, slow_s=0.3))
    _, hist = train_loop(_dummy_step, _w(), _stream(shard_dir),
                         total_steps=6, log_every=1, faults=inj,
                         watchdog_factor=5.0)
    assert hist[-1]["slow_steps"] >= 1


def test_fault_plan_from_env():
    plan = FaultPlan.from_env({"REPRO_FAULTS":
                               "crash_at=6, torn_at=3,torn_bytes=128"})
    assert plan.crash_at == 6 and plan.torn_at == 3 and plan.torn_bytes == 128
    assert plan.crash_code == 43
    assert FaultPlan.from_env({}) == FaultPlan()
    assert not FaultPlan.from_env({}).any
    with pytest.raises(ValueError):
        FaultPlan.from_env({"REPRO_FAULTS": "bogus=1"})


def test_loss_scale_summary_matches_the_reference():
    got = amp.loss_scale_summary(amp.LossScaleState(2.0 ** 13, 5, 2))
    want = jamp.loss_scale_summary(jamp.LossScaleState(
        np.float32(2.0 ** 13), np.int32(5), np.int32(2)))
    assert got == want and [type(v) for v in got.values()] == \
        [type(v) for v in want.values()]


# ---------------------------------------------------------------------------
# The port's TrainState through the loop: the f16 overflow skip, and a step
# that raises part-way through the optimizer update
# ---------------------------------------------------------------------------

def _bert_state(precision, seed=0, optimizer="lamb"):
    tcfg = TrainConfig(precision=precision, accum_steps=1, warmup_steps=1,
                       total_steps=10, optimizer=optimizer)
    pol = amp.make_policy(precision)
    params = api.init_params(CFG, seed=seed, device="cpu")
    return ts.init_train_state(params, pol, tcfg, cfg=CFG), tcfg, pol


def _bert_batches(n, seed=1):
    shape = InputShape("t", 64, 4, "train")
    return [api.make_synth_batch(seed + i, CFG, shape) for i in range(n)]


def _bert_step(tcfg, pol):
    def step(state, batch):
        return ts.train_step_fn(state, api.to_device(batch, "cpu"), cfg=CFG,
                                tcfg=tcfg, policy=pol)
    return step


def _snapshot(state):
    return ({n: {p: t.clone() for p, t in getattr(state.opt, n).items()}
             for n in ("master", "m", "v")}, state.opt.step,
            state.loss_scale)


def _assert_state_is(state, snap):
    tensors, step, ls = snap
    assert state.opt.step == step and state.loss_scale == ls
    for n, saved in tensors.items():
        for p, t in saved.items():
            assert torch.equal(getattr(state.opt, n)[p], t), (n, p)


def test_f16_overflow_step_skips_update_and_backs_off():
    """The AMP skip observed through the loop: a real overflow is skipped
    (master weights untouched), the scale backs off, and the loop counts
    it as a skip."""
    state, tcfg, pol = _bert_state("f16")
    state.loss_scale = amp.LossScaleState(2.0 ** 100, 0, 0)  # f16 grads: inf
    snap = _snapshot(state)
    state, hist = train_loop(_bert_step(tcfg, pol), state,
                             iter(_bert_batches(1)), total_steps=1,
                             log_every=1, max_consecutive_skips=3)
    assert hist[0]["skipped"] == 1.0 and hist[0]["total_skips"] == 1
    assert state.loss_scale == amp.LossScaleState(2.0 ** 99, 0, 1)
    _assert_state_is(state, (snap[0], 0, state.loss_scale))


def _raise_on_call(monkeypatch, n, times=1):
    """Make the LAMB moment kernel's dispatcher raise on its ``n``-th call
    (the ``n``-th group of a step), ``times`` times in all."""
    real, calls = ops.lamb_moments, {"n": 0, "raised": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == n and calls["raised"] < times:
            calls["raised"] += 1
            calls["n"] = 0
            raise RuntimeError("injected kernel failure")
        return real(*a, **kw)
    monkeypatch.setattr(ops, "lamb_moments", flaky)
    return calls


def test_a_step_that_raises_mid_update_leaves_the_state_untouched(
        monkeypatch):
    """The LAMB update raises on its third group: master, m, v, the step
    count and the loss scale (f16, so a completed step would move its good
    steps) are bit-identical to before.  Through the loop the retry then
    re-runs the step from that state, to the bits of a run without the
    failure."""
    state, tcfg, pol = _bert_state("f16")
    batches = _bert_batches(2)
    step = _bert_step(tcfg, pol)
    step(state, batches[0])       # moments and loss scale not at init
    snap = _snapshot(state)
    calls = _raise_on_call(monkeypatch, 3)
    with pytest.raises(RuntimeError, match="injected"):
        step(state, batches[1])
    assert calls["raised"] == 1
    _assert_state_is(state, snap)

    clean, _, _ = _bert_state("f16")
    for batch in batches:
        step(clean, batch)
    state, _, _ = _bert_state("f16")
    _raise_on_call(monkeypatch, 3)
    state, hist = train_loop(step, state, iter(batches), total_steps=2,
                             log_every=1, retry_backoff_s=0.0)
    assert hist[-1]["retries"] == 1
    _assert_state_is(state, _snapshot(clean))


class _FlakySqrt:
    """Stands in for ``torch`` inside ``optim/adamw.py``: its ``sqrt``
    (one call a leaf group) raises on the ``n``-th call, once."""

    def __init__(self, n):
        self.n, self.calls, self.raised = n, 0, 0

    def __getattr__(self, name):
        return getattr(torch, name)

    def sqrt(self, x):
        self.calls += 1
        if self.calls == self.n and not self.raised:
            self.raised += 1
            raise RuntimeError("injected failure in the AdamW update")
        return torch.sqrt(x)


def test_an_adamw_step_that_raises_mid_update_leaves_the_state_untouched(
        monkeypatch):
    """The AdamW update raises on its third group: master, m, v, the step
    count and the loss scale are bit-identical to before; through the
    loop the retry re-runs the step to the bits of a run without the
    failure."""
    from repro_torch.optim import adamw
    state, tcfg, pol = _bert_state("f16", optimizer="adamw")
    batches = _bert_batches(2)
    step = _bert_step(tcfg, pol)
    step(state, batches[0])       # moments and loss scale not at init
    snap = _snapshot(state)
    flaky = _FlakySqrt(3)
    monkeypatch.setattr(adamw, "torch", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        step(state, batches[1])
    assert flaky.raised == 1
    _assert_state_is(state, snap)

    monkeypatch.setattr(adamw, "torch", torch)
    clean, _, _ = _bert_state("f16", optimizer="adamw")
    for batch in batches:
        step(clean, batch)
    state, _, _ = _bert_state("f16", optimizer="adamw")
    flaky = _FlakySqrt(len(state.opt.groups.paths) + 3)  # in step 2
    monkeypatch.setattr(adamw, "torch", flaky)
    state, hist = train_loop(step, state, iter(batches), total_steps=2,
                             log_every=1, retry_backoff_s=0.0)
    assert flaky.raised == 1 and hist[-1]["retries"] == 1
    _assert_state_is(state, _snapshot(clean))


# ---------------------------------------------------------------------------
# Interchange with the reference's checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_state():
    """The reference's ``TrainState`` of the smoke BERT with moments, step
    and loss scale away from their initial values (numpy leaves), and the
    port's state bridged from the same numbers."""
    jparams = jax.jit(lambda key: japi.init_params(key, JCFG)[0])(
        jax.random.PRNGKey(0))
    jstate = jts.init_train_state(jparams, jamp.make_policy("f32"),
                                  JTrainConfig())
    rng = np.random.default_rng(0)
    master = jax.tree_util.tree_map(np.asarray, jstate.opt.master)
    m = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), master)
    v = jax.tree_util.tree_map(
        lambda x: rng.random(x.shape).astype(np.float32), master)
    jstate = jstate._replace(
        opt=jstate.opt._replace(step=np.int32(7), master=master, m=m, v=v),
        loss_scale=jamp.LossScaleState(np.float32(2.0 ** 13), np.int32(5),
                                       np.int32(2)))
    tcfg = TrainConfig(precision="f32", accum_steps=1, warmup_steps=2,
                       total_steps=20)
    pol = amp.make_policy("f32")
    state = ts.init_train_state(
        bridge.params_from_jax(master, CFG, device="cpu"), pol, tcfg,
        cfg=CFG)
    groups = state.opt.groups
    state.opt.m = groups.flatten(bridge.params_from_jax(m, CFG, device="cpu"))
    state.opt.v = groups.flatten(bridge.params_from_jax(v, CFG, device="cpu"))
    state.opt.step = 7
    state.loss_scale = amp.LossScaleState(2.0 ** 13, 5, 2)
    return jstate, state, tcfg, pol


def _keys(path):
    return tuple(k.key for k in path)


def test_port_restores_a_reference_checkpoint_bit_for_bit(tmp_path,
                                                          ref_state):
    jstate, _, _, _ = ref_state
    d = str(tmp_path)
    jckpt.save_checkpoint(d, 7, jstate)
    assert len(load_manifest(d, 7)["names"]) == 82
    state, _, _ = _bert_state("f32", seed=5)   # other weights
    got, step = restore_checkpoint(d, state)
    assert got is state and step == 7
    assert state.opt.step == 7
    assert state.loss_scale == amp.LossScaleState(2.0 ** 13, 5, 2)
    for name in ("master", "m", "v"):
        stacked = state.opt.groups.stacked(getattr(state.opt, name))
        want = jax.tree_util.tree_flatten_with_path(
            getattr(jstate.opt, name))[0]
        assert len(want) == len(stacked) == 26
        for path, w in want:
            got_a = stacked[_keys(path)].numpy()
            assert got_a.dtype == np.float32 and got_a.shape == w.shape
            assert got_a.tobytes() == np.asarray(w).tobytes(), (name, path)


def test_reference_restores_a_port_checkpoint_bit_for_bit(tmp_path,
                                                          ref_state):
    jstate, state, _, _ = ref_state
    port, ref = tmp_path / "port", tmp_path / "ref"
    save_checkpoint(str(port), 7, state, extra={"k": 1})
    jckpt.save_checkpoint(str(ref), 7, jstate)
    assert jckpt.validate_checkpoint(str(port), 7)
    pm, rm = load_manifest(str(port), 7), load_manifest(str(ref), 7)
    for key in ("format", "step", "names", "shapes", "dtypes", "checksums"):
        assert pm[key] == rm[key], key
    got, step = jckpt.restore_checkpoint(str(port), like=jstate)
    assert step == 7
    want_leaves = jax.tree_util.tree_leaves(jstate)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves) == 82
    for g, w in zip(got_leaves, want_leaves):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_a_step_after_restoring_a_reference_checkpoint_matches(tmp_path,
                                                               ref_state):
    """One port step from the reference's checkpoint equals, bit for bit,
    one step from the state bridged from the same numbers."""
    jstate, bridged, tcfg, pol = ref_state
    jckpt.save_checkpoint(str(tmp_path), 7, jstate)
    restored, _, _ = _bert_state("f32", seed=5)
    restore_checkpoint(str(tmp_path), restored)
    batch = _bert_batches(1, seed=9)[0]
    bridged_copy, _, _ = _bert_state("f32", seed=5)
    save_checkpoint(str(tmp_path / "b"), 7, bridged)
    restore_checkpoint(str(tmp_path / "b"), bridged_copy)  # keep the fixture
    outs = [_bert_step(tcfg, pol)(s, batch) for s in (restored, bridged_copy)]
    (s1, m1), (s2, m2) = outs
    assert float(m1["loss"]) == float(m2["loss"])
    assert s1.opt.step == s2.opt.step == 8
    _assert_state_is(s1, _snapshot(s2))


def test_restore_refuses_another_structure_and_writes_nothing(tmp_path,
                                                              ref_state):
    jstate, _, _, _ = ref_state
    jckpt.save_checkpoint(str(tmp_path), 7, jstate)
    other = smoke_variant(get_config("bert-large"), d_model=32, n_blocks=2)
    state = ts.init_train_state(api.init_params(other, seed=0, device="cpu"),
                                amp.make_policy("f32"), TrainConfig(),
                                cfg=other)
    snap = _snapshot(state)
    with pytest.raises(FileNotFoundError, match="restorable"):
        restore_checkpoint(str(tmp_path), state)
    _assert_state_is(state, snap)


# ---------------------------------------------------------------------------
# Crash -> resume through the real launcher CLI (subprocess, REPRO_FAULTS)
# ---------------------------------------------------------------------------

# 21 phase-1 steps (checkpoints at 10, 20 and the final 21; a loss logged
# every 2 steps and at 21) and 2 phase-2 steps (both logged).  The fault
# steps (15; 20 and 21) exist in phase 1 only.
STEPS = 23
LOGGED = [("phase1", s) for s in list(range(2, 21, 2)) + [21]] + \
    [("phase2", 1), ("phase2", 2)]


def _cli(tmp, tag, extra_args=(), faults=""):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    env.pop("REPRO_FAULTS", None)
    if faults:
        env["REPRO_FAULTS"] = faults
    args = ["--device", "cpu", "--steps", str(STEPS), "--batch", "8",
            "--accum", "1", "--d-model", "32", "--workdir", f"{tmp}/{tag}",
            "--loss-log", f"{tmp}/{tag}.jsonl"] + list(extra_args)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.pretrain_bert"] + args,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc, expect_code=0):
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == expect_code, \
        f"expected exit {expect_code}, got {proc.returncode}:\n{out}"
    return out


def _loss_log(path):
    out = {}
    for line in Path(path).read_text().splitlines():
        r = json.loads(line)
        out[(r["phase"], r["step"])] = r["loss"]
    return out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The uninterrupted run and the two faulted runs, at once."""
    tmp = str(tmp_path_factory.mktemp("cli"))
    procs = {"ref": _cli(tmp, "ref"),
             "chaos": _cli(tmp, "chaos", faults="crash_at=15"),
             "torn": _cli(tmp, "torn", faults="torn_at=20,crash_at=21")}
    _finish(procs["ref"])
    _finish(procs["chaos"], 43)
    _finish(procs["torn"], 43)
    return tmp


def _assert_same_bits(merged, ref):
    assert sorted(ref) == LOGGED
    for key, loss in ref.items():
        assert merged[key].hex() == loss.hex(), \
            f"{key}: resumed {merged[key]!r} != uninterrupted {loss!r}"


def test_cli_crash_resume_loss_bit_identical(cli_runs):
    """Kill a run mid-training by an injected hard crash, resume from the
    surviving checkpoint, and the losses are bit-identical to an
    uninterrupted run's (same seed, same data order)."""
    tmp = cli_runs
    ref = _loss_log(f"{tmp}/ref.jsonl")
    crashed = _loss_log(f"{tmp}/chaos.jsonl")
    assert sorted(crashed) == [("phase1", s) for s in range(2, 15, 2)]
    assert latest_step(f"{tmp}/chaos/ckpt/phase1") == 10
    out = _finish(_cli(tmp, "chaos", ["--resume"]))  # appends 11..21, p2
    assert "resumed from checkpoint step 10" in out
    _assert_same_bits(_loss_log(f"{tmp}/chaos.jsonl"), ref)


def test_cli_torn_checkpoint_recovery(cli_runs):
    """The step-20 checkpoint is torn as it is written, then the run
    crashes after step 21: the resume falls back to step 10, loudly, and
    still reproduces the uninterrupted losses."""
    tmp = cli_runs
    ckpt = f"{tmp}/torn/ckpt/phase1"
    assert not validate_checkpoint(ckpt, 20)
    assert latest_step(ckpt) == 10
    out = _finish(_cli(tmp, "torn", ["--resume"]))
    assert "skipping corrupt checkpoint step 20" in out
    assert "resumed from checkpoint step 10" in out
    _assert_same_bits(_loss_log(f"{tmp}/torn.jsonl"),
                      _loss_log(f"{tmp}/ref.jsonl"))
