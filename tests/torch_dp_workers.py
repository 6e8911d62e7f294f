"""Rank functions of the data-parallel parity tests
(``tests/test_torch_collectives.py``, ``tests/test_torch_dp.py``).

``launch.mesh.spawn`` starts each rank in a new process, which imports the
function by name: kept here, apart from the test files, a rank imports
torch and the port only, not JAX.  Each rank writes what it computed to
``.npz`` files; the test compares the files with the reference's, which
runs in a subprocess at the same time (``run_dp``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.core import collectives as C
from repro_torch.core.amp import make_policy
from repro_torch.launch import mesh as M
from repro_torch.models import api
from repro_torch.train import train_step as ts

RING_SIZES = (40, 37, 5, 1)
HIER_SIZES = (36, 37)
# bucketed: at 64 bytes, leaves of 12, 20, 28 bytes share a bucket; 160
# and 8 bytes go alone
BUCKET_LEAVES = {"a": 3, "b": 5, "c": 7, "d": 40, "e": 2}
DP_STRATEGIES = ("psum", "ring", "bucketed", "hierarchical")


def collectives_rank(mesh, data_path, out_dir):
    """Every case of ``test_torch_collectives.py`` on this rank's row of
    each (world, size) input: ``mesh`` has 8 ranks in 2 pods."""
    data = np.load(data_path)
    r = mesh.rank

    def row(name):
        return torch.from_numpy(data[name][r:r + 1].copy())

    out = {}
    for size in RING_SIZES:
        out[f"ring{size}"] = C.ring_all_reduce(row(f"ring{size}"),
                                               mesh.group)
    out["ring_2axis"] = C.ring_all_reduce(row("ring_2axis"), mesh.group)
    for size in HIER_SIZES:
        out[f"hier{size}"] = C.hierarchical_psum(
            row(f"hier{size}"), mesh.fast_group, mesh.pod_group, mesh.group)
    out["psum"] = C.psum(row("psum"), mesh.group)
    tree = [row(f"bucket_{k}") for k in sorted(BUCKET_LEAVES)]
    for k, x in zip(sorted(BUCKET_LEAVES),
                    C.bucketed_psum_tree(tree, mesh.group, bucket_bytes=64)):
        out[f"bucket_{k}"] = x
    for s in ("psum", "ring", "hierarchical", "bucketed"):
        x = C.reduce_gradients([row("reduce")], strategy=s, mesh=mesh,
                               bucket_bytes=64)[0]
        out[f"reduce_{s}"] = x
    np.savez(Path(out_dir) / f"rank{r}.npz",
             **{k: v.numpy() for k, v in out.items()})


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------

DP_CFG = smoke_variant(get_config("bert-large"), d_model=64)


def dp_tcfg(strategy: str, precision: str = "f32") -> TrainConfig:
    # 2**16 bytes: the 26 gradient groups of DP_CFG fall into 6 buckets
    return TrainConfig(precision=precision, accum_steps=2,
                       collective_strategy=strategy, bucket_bytes=2 ** 16,
                       total_steps=10, warmup_steps=1)


def dp_state(params_path, precision="f32"):
    params = dict(np.load(params_path, allow_pickle=True))["params"].item()
    return ts.init_train_state(
        bridge.params_from_jax(params, DP_CFG, device="cpu"),
        make_policy(precision), dp_tcfg("psum", precision))


def state_arrays(state, m) -> dict:
    """The post-step state and metrics as named numpy arrays."""
    out = {f"{n}/{'.'.join(p)}": t.numpy().copy()
           for n in ("master", "m", "v")
           for p, t in state.opt.groups.stacked(
               getattr(state.opt, n)).items()}
    out.update({f"metric/{k}": np.float64(float(v)) for k, v in m.items()})
    out["opt/step"] = np.int64(state.opt.step)
    out["loss_scale"] = np.asarray(state.loss_scale, np.float64)
    out["digest"] = np.asarray(state.digest())
    return out


def dp_rank(mesh, params_path, batch_path, out_dir, strategies, bad_rank):
    """One step of each of ``strategies`` from the same state on the same
    global batch (``hierarchical`` needs a mesh of 2 pods), then, unless
    ``bad_rank`` is None, the f16 step of ``dp_f16_skip``."""
    batch = api.to_device(dict(np.load(batch_path)), "cpu")
    for strategy in strategies:
        state = dp_state(params_path)
        step = ts.make_train_step_dp(DP_CFG, dp_tcfg(strategy), mesh)
        state, m = step(state, batch)
        np.savez(Path(out_dir) / f"{strategy}_rank{mesh.rank}.npz",
                 **state_arrays(state, m))
    if bad_rank is not None:
        dp_f16_skip(mesh, params_path, batch, out_dir, bad_rank)


def dp_world1_rank(mesh, params_path, batch_path, out_dir):
    """At world 1 the DP step against the port's own ``train_step_fn``."""
    batch = api.to_device(dict(np.load(batch_path)), "cpu")
    tcfg = dp_tcfg("ring")
    got, m = ts.make_train_step_dp(DP_CFG, tcfg, mesh)(dp_state(params_path),
                                                       batch)
    want, wm = ts.train_step_fn(dp_state(params_path), batch, cfg=DP_CFG,
                                tcfg=tcfg, policy=make_policy("f32"))
    np.savez(Path(out_dir) / "dp.npz", **state_arrays(got, m))
    np.savez(Path(out_dir) / "single.npz", **state_arrays(want, wm))


def dp_f16_skip(mesh, params_path, batch, out_dir, bad_rank):
    """f16: rank ``bad_rank``'s loss (so its gradient) made infinite in its
    own process alone.  Every rank writes its state before and after."""
    if mesh.rank == bad_rank:
        make = api.make_loss_fn

        def make_bad(*a, **kw):
            fn = make(*a, **kw)

            def bad(params, b):
                loss, metrics = fn(params, b)
                return loss * float("inf"), metrics
            return bad
        api.make_loss_fn = make_bad
    state = dp_state(params_path, "f16")
    state.loss_scale = state.loss_scale._replace(good_steps=5)
    before = state_arrays(state, {})
    state, m = ts.make_train_step_dp(DP_CFG, dp_tcfg("ring", "f16"),
                                     mesh)(state, batch)
    np.savez(Path(out_dir) / f"f16_rank{mesh.rank}.npz",
             **{f"before/{k}": v for k, v in before.items()},
             **{f"after/{k}": v for k, v in state_arrays(state, m).items()})



# ---------------------------------------------------------------------------
# the reference's data-parallel step beside the port's
# ---------------------------------------------------------------------------

DP_BATCH, DP_SEQ, BAD_RANK = 16, 32, 2
SRC = Path(__file__).resolve().parent.parent / "src"

REF_DP_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, smoke_variant
from repro.configs.base import TrainConfig, InputShape
from repro.core.amp import make_policy
from repro.core.compat import make_mesh
from repro.train.train_step import init_train_state, make_train_step_dp
cfg = smoke_variant(get_config("bert-large"), d_model=64)
params = jax.tree_util.tree_map(
    jnp.asarray, np.load(sys.argv[1], allow_pickle=True)["params"].item())
batch = {k: jnp.asarray(v) for k, v in np.load(sys.argv[2]).items()}
shape = InputShape("t", %(seq)d, %(batch)d, "train")
MESHES = {"hierarchical": ((2, 2), ("pod", "data"))}
out = {}
for strat in %(strategies)r:
    mesh = make_mesh(*MESHES.get(strat, ((4,), ("data",))))
    tcfg = TrainConfig(precision="f32", accum_steps=2,
                       collective_strategy=strat, bucket_bytes=2 ** 16,
                       total_steps=10, warmup_steps=1)
    step, _ = make_train_step_dp(cfg, tcfg, mesh, shape)
    state = init_train_state(params, make_policy("f32"), tcfg)
    state, m = step(state, batch)
    for name in ("master", "m", "v"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                getattr(state.opt, name))[0]:
            key = ".".join(k.key for k in path)
            out[f"{strat}/{name}/{key}"] = np.asarray(leaf)
    out[f"{strat}/opt/step"] = np.asarray(state.opt.step)
    for k, v in m.items():
        out[f"{strat}/metric/{k}"] = np.asarray(v, np.float64)
np.savez(sys.argv[3], **out)
print("OK")
"""


def dp_batch(seed: int) -> dict:
    """A seeded global batch of DP_BATCH x DP_SEQ tokens for DP_CFG."""
    rng = np.random.default_rng(seed)
    b, s, v = DP_BATCH, DP_SEQ, DP_CFG.vocab_size
    p = api.mlm_positions_count(s)
    labels = rng.integers(5, v, (b, p)).astype(np.int32)
    labels[:, p // 2:][rng.random((b, p - p // 2)) < 0.5] = -100
    type_ids = np.zeros((b, s), np.int32)
    type_ids[:, s // 2:] = 1
    return {"tokens": rng.integers(5, v, (b, s)).astype(np.int32),
            "type_ids": type_ids,
            "mlm_positions": np.sort(rng.choice(np.arange(1, s), (b, p)),
                                     axis=1).astype(np.int32),
            "mlm_labels": labels,
            "nsp_labels": rng.integers(0, 2, b).astype(np.int32)}


def run_dp(tmp: Path, params: dict, batch: dict, ref_strategies,
           port_strategies, *, extras: bool):
    """The reference's DP step for ``ref_strategies`` in a subprocess over
    4 forced host devices, and at the same time the port's for
    ``port_strategies`` on 4 gloo ranks in 2 pods (with ``extras``, also
    the f16 skip and the world-1 step).  ``params`` are the reference's
    weights as numpy.  Returns (reference outputs, {(strategy, rank):
    port outputs}, world-1 outputs or None)."""
    np.savez(tmp / "params.npz", params=np.asarray(params, dtype=object))
    np.savez(tmp / "batch.npz", **batch)
    files = [str(tmp / "params.npz"), str(tmp / "batch.npz")]
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = REF_DP_CODE % {"seq": DP_SEQ, "batch": DP_BATCH,
                          "strategies": tuple(ref_strategies)}
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), *files,
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    (tmp / "w1").mkdir()
    try:
        M.spawn(dp_rank, 4, args=(*files, str(tmp), tuple(port_strategies),
                                  BAD_RANK if extras else None),
                device="cpu", pods=2, timeout_s=60, wait_s=240)
        if extras:   # world 1: a process group of this process alone
            mesh = M.init_mesh("cpu", rank=0, world=1, timeout_s=60,
                               init_method=f"file://{tmp / 'w1' / 'store'}")
            try:
                dp_world1_rank(mesh, *files, str(tmp / "w1"))
            finally:
                mesh.close()
        out, _ = ref.communicate(timeout=240)
    finally:
        ref.kill()
    if ref.returncode != 0 or "OK" not in out:
        raise AssertionError(f"the reference's DP step failed:\n{out}")
    names = tuple(port_strategies) + (("f16",) if extras else ())
    port = {(s, r): dict(np.load(tmp / f"{s}_rank{r}.npz"))
            for s in names for r in range(4)}
    w1 = {k: dict(np.load(tmp / "w1" / f"{k}.npz"))
          for k in ("dp", "single")} if extras else None
    return dict(np.load(tmp / "ref.npz")), port, w1


# ---------------------------------------------------------------------------
# the supervised loop under data parallelism (``tests/test_torch_dp_loop.py``)
# ---------------------------------------------------------------------------

LOOP_STEPS = 4


def _counter_step(mesh, fail_rank=None, fail_step=None):
    """A step that all-reduces a one on every rank and adds the sum to the
    state; on ``fail_rank`` at step ``fail_step`` its first attempt raises
    a ``RuntimeError`` after the all-reduce."""
    failed = []

    def step(state, batch):
        total = C.psum(torch.ones(1), mesh.group)
        if mesh.rank == fail_rank and batch == fail_step and not failed:
            failed.append(batch)
            raise RuntimeError(f"rank {mesh.rank} fails after the exchange")
        return {"w": state["w"] + total}, {"loss": torch.ones(())}
    return step


def loop_rank(mesh, case, out_dir):
    """``train_loop`` over ``_counter_step`` on this rank in ``case``;
    writes the rank's final counter and retries, or the error that ended
    its run."""
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.faults import FaultInjector, FaultPlan
    from repro_torch.train.trainer import train_loop

    out_dir = Path(out_dir)
    plan, step, ckpt_dir = FaultPlan(), _counter_step(mesh), None
    if case == "one_rank_error":
        step = _counter_step(mesh, fail_rank=1, fail_step=2)
    elif case == "transient_everywhere":
        plan = FaultPlan(fail_at=2)
    elif case in ("resume_shared", "resume_apart"):
        # rank 0's directory holds the checkpoint of step 2; with
        # "resume_apart" the other rank reads a directory of its own
        shared = out_dir / f"{case}_ckpt"
        if mesh.rank == 0:
            save_checkpoint(str(shared), 2, {"w": torch.full((1,), 4.0)})
        mesh.barrier()
        ckpt_dir = str(shared if case == "resume_shared" or mesh.rank == 0
                       else out_dir / f"{case}_ckpt_rank{mesh.rank}")
    result = {"error": None}
    try:
        state, history = train_loop(
            step, {"w": torch.zeros(1)}, iter(range(1, LOOP_STEPS + 1)),
            total_steps=LOOP_STEPS, log_every=1, ckpt_dir=ckpt_dir,
            ckpt_every=100, resume=ckpt_dir is not None,
            retry_backoff_s=0.0, faults=FaultInjector(plan), mesh=mesh)
        result.update(w=float(state["w"]), retries=history[-1]["retries"],
                      steps=[h["step"] for h in history])
    except Exception as e:  # noqa: BLE001 -- the outcome is the result
        result["error"] = f"{type(e).__name__}: {e}"
    (out_dir / f"{case}_rank{mesh.rank}.json").write_text(json.dumps(result))
