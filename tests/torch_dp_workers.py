"""Rank functions of the data-parallel parity tests
(``tests/test_torch_collectives.py``, ``tests/test_torch_dp.py``).

``launch.mesh.spawn`` starts each rank in a new process, which imports the
function by name: kept here, apart from the test files, a rank imports
torch and the port only, not JAX.  Each rank writes what it computed to
``.npz`` files; the test compares the files with the reference's, which
runs in a subprocess at the same time (``run_dp``).
"""
from __future__ import annotations

import dataclasses
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
        make_policy(precision), dp_tcfg("psum", precision), cfg=DP_CFG)


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


# ---------------------------------------------------------------------------
# the compressed exchange (``tests/test_torch_compression.py``)
# ---------------------------------------------------------------------------

COMP_LEAVES = {"a": (37,), "b": (5, 3), "c": (211,)}
# case -> (mode, strategy, bucket_bytes); at 64 bytes int8 takes a, b and
# c each alone after the first (148 + 60 > 64)
COMP_CASES = {
    "fp16_psum": ("fp16", "psum", 64),
    "fp16_ring": ("fp16", "ring", 64),
    "fp16_hierarchical": ("fp16", "hierarchical", 64),
    "fp16_bucketed": ("fp16", "bucketed", 256),
    "int8_psum": ("int8", "psum", 64),
    "int8_bucketed": ("int8", "bucketed", 1 << 16),
    "int8_hierarchical": ("int8", "hierarchical", 256),
    "int8_nonfinite": ("int8", "psum", 1 << 16),
    "fp16_nonfinite": ("fp16", "psum", 1 << 16),
}


def compression_inputs(seed: int) -> dict:
    """Per case and leaf, a (4, *shape) float32 gradient (a row a rank)
    and residual: normal x 2 (``tests/test_compression.py:109``) and a
    small residual; the non-finite cases are ones with rank 2's element 3
    NaN and a residual of 0.25 (``:147``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for case in COMP_CASES:
        for k, shape in COMP_LEAVES.items():
            if case.endswith("nonfinite"):
                g = np.ones((4,) + shape, np.float32)
                if k == "a":
                    g[2, 3] = np.nan
                e = np.full((4,) + shape, 0.25, np.float32)
            else:
                g = (rng.standard_normal((4,) + shape) * 2.0)
                e = rng.standard_normal((4,) + shape) * 0.01
            out[f"{case}/g/{k}"] = g.astype(np.float32)
            out[f"{case}/e/{k}"] = e.astype(np.float32)
    return out


def compression_rank(mesh, data_path, out_dir):
    """Every case of ``COMP_CASES`` on this rank's rows (4 ranks, 2 pods)."""
    data = np.load(data_path)
    r, keys = mesh.rank, sorted(COMP_LEAVES)

    def rows(case, kind):
        return [torch.from_numpy(data[f"{case}/{kind}/{k}"][r].reshape(-1)
                                 .copy()) for k in keys]

    # the reference runs these over a flat (4,) mesh, hierarchical over
    # (pod 2, data 2)
    flat = dataclasses.replace(mesh, pods=1, fast_group=None,
                               pod_group=None)
    out = {}
    for case, (mode, strategy, bucket_bytes) in COMP_CASES.items():
        red, err, fin = C.compressed_reduce_gradients(
            rows(case, "g"), rows(case, "e"), strategy=strategy, mode=mode,
            mesh=mesh if strategy == "hierarchical" else flat,
            bucket_bytes=bucket_bytes)
        out[f"{case}/fin"] = np.asarray(bool(fin))
        out[f"{case}/aligned"] = np.asarray(all(
            x.is_contiguous() and x.data_ptr() % 16 == 0 for x in red))
        for k, x, e in zip(keys, red, err):
            out[f"{case}/red/{k}"] = x.reshape(COMP_LEAVES[k]).numpy()
            out[f"{case}/err/{k}"] = e.reshape(COMP_LEAVES[k]).numpy()
    np.savez(Path(out_dir) / f"rank{r}.npz", **out)


REF_COMP_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.compat import make_mesh, shard_map
from repro.core.collectives import compressed_reduce_gradients
data = dict(np.load(sys.argv[1]))
out = {}
for case, (mode, strategy, bucket_bytes) in %(cases)r.items():
    if strategy == "hierarchical":
        mesh, rows, pod = make_mesh((2, 2), ("pod", "data")), \\
            P(("pod", "data")), "pod"
    else:
        mesh, rows, pod = make_mesh((4,), ("data",)), P("data"), None
    def f(g, e):
        g = {k: v[0] for k, v in g.items()}
        e = {k: v[0] for k, v in e.items()}
        red, new_err, fin = compressed_reduce_gradients(
            g, e, strategy=strategy, mode=mode, data_axes=("data",),
            pod_axis=pod, bucket_bytes=bucket_bytes)
        return ({k: v[None] for k, v in red.items()},
                {k: v[None] for k, v in new_err.items()}, fin)
    tree = lambda kind: {k: data[f"{case}/{kind}/{k}"] for k in %(leaves)r}
    red, err, fin = jax.jit(shard_map(
        f, mesh=mesh, in_specs=(rows, rows), out_specs=(rows, rows, P()),
        check_vma=False))(tree("g"), tree("e"))
    out[f"{case}/fin"] = np.asarray(fin)
    for k in %(leaves)r:
        out[f"{case}/red/{k}"] = np.asarray(red[k])
        out[f"{case}/err/{k}"] = np.asarray(err[k])
np.savez(sys.argv[2], **out)
print("OK")
"""


def run_reference(code: str, args, n_devices: int) -> subprocess.Popen:
    """Start ``code`` in a subprocess over ``n_devices`` forced host
    devices (the reference side of a test); ``args`` go to its argv."""
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices}")
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_reference(ref: subprocess.Popen, timeout: float = 240) -> str:
    """Wait for ``run_reference``'s process; raise unless it printed OK."""
    try:
        out, _ = ref.communicate(timeout=timeout)
    finally:
        ref.kill()
    if ref.returncode != 0 or "OK" not in out:
        raise AssertionError(f"the reference failed:\n{out}")
    return out


def run_compression(tmp: Path, data: dict):
    """The reference's and the port's compressed exchange of ``data`` at
    once: (reference outputs, [the port's outputs a rank])."""
    np.savez(tmp / "in.npz", **data)
    code = REF_COMP_CODE % {"cases": COMP_CASES,
                            "leaves": tuple(sorted(COMP_LEAVES))}
    ref = run_reference(code, [tmp / "in.npz", tmp / "ref.npz"], 4)
    try:
        M.spawn(compression_rank, 4, args=(str(tmp / "in.npz"), str(tmp)),
                device="cpu", pods=2, timeout_s=60, wait_s=240)
    except BaseException:
        ref.kill()
        raise
    finish_reference(ref)
    return (dict(np.load(tmp / "ref.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)])


# ---------------------------------------------------------------------------
# the overlapped drain and the compressed step (``tests/test_torch_overlap.
# py``, ``tests/test_torch_compression_resume.py``)
# ---------------------------------------------------------------------------

def step_case(strategy: str, accum: int = 2, overlap: bool = False,
              comp: str = "none", bucket_bytes: int = 2 ** 16
              ) -> TrainConfig:
    """The f32 step of ``tests/test_overlap.py`` (lr warmup 2 of 50)."""
    return TrainConfig(precision="f32", accum_steps=accum,
                       collective_strategy=strategy, overlap_exchange=overlap,
                       grad_compression=comp, bucket_bytes=bucket_bytes,
                       total_steps=50, warmup_steps=2)


def case_name(strategy, accum=2, overlap=False, comp="none",
              bucket_bytes=2 ** 16) -> str:
    return (f"{strategy}_a{accum}_{comp}_{'overlap' if overlap else 'serial'}"
            f"_b{bucket_bytes}")


def _params(params_path):
    params = dict(np.load(params_path, allow_pickle=True))["params"].item()
    return bridge.params_from_jax(params, DP_CFG, device="cpu")


def run_case(mesh, params, batches, tcfg, state=None):
    """``make_train_step_dp`` over ``batches`` from ``params`` (or from
    ``state``); returns (state, losses, bucket start orders)."""
    if state is None:
        state = ts.init_train_state(params, make_policy("f32"), tcfg,
                                    cfg=DP_CFG, world=mesh.world,
                                    rank=mesh.rank)
    step = ts.make_train_step_dp(DP_CFG, tcfg, mesh)
    losses, orders = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        orders.append(step.bucket_order)
    return state, losses, orders


def case_record(state, losses, orders) -> dict:
    out = {"losses": np.asarray(losses, np.float64),
           "digest": np.asarray(state.digest()),
           "orders": np.asarray(json.dumps(orders))}
    if state.err is not None:
        out["residual_digest"] = np.asarray(state.residual_digest())
        out["residual_max"] = np.float64(max(
            float(e.abs().max()) for e in state.err.values()))
    return out


def load_batches(path) -> list:
    """The batches of ``save_batches``, as tensors on the host."""
    data = dict(np.load(path))
    n = len({k.split("/")[0] for k in data})
    return [api.to_device({k.split("/")[1]: v for k, v in data.items()
                           if k.split("/")[0] == str(i)}, "cpu")
            for i in range(n)]


def overlap_rank(mesh, params_path, batches_path, out_dir, cases):
    """Each of ``cases`` (``step_case`` keyword dicts) from the same
    weights over the same batches on this rank."""
    params = _params(params_path)
    batches = load_batches(batches_path)
    out = {}
    for kw in cases:
        rec = case_record(*run_case(mesh, params, batches, step_case(**kw)))
        out.update({f"{case_name(**kw)}/{k}": v for k, v in rec.items()})
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **out)


def resume_rank(mesh, params_path, batches_path, out_dir, cases):
    """For each of ``cases``: 4 straight steps, then 2 steps, a checkpoint
    (every rank's residual gathered to rank 0, which writes), a restore
    into a fresh state on every rank and 2 more steps."""
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    params = _params(params_path)
    batches = load_batches(batches_path)
    out = {}
    for kw in cases:
        name, tcfg = case_name(**kw), step_case(**kw)
        straight, losses, _ = run_case(mesh, params, batches, tcfg)
        state, first, _ = run_case(mesh, params, batches[:2], tcfg)
        ckpt = Path(out_dir) / f"ckpt_{name}"
        rows = None if state.err is None else ts.gather_residual(state, mesh)
        if mesh.rank == 0:
            save_checkpoint(str(ckpt), 2, ts.ResidualRows(state, rows))
        mesh.barrier()
        fresh = ts.init_train_state(params, make_policy("f32"), tcfg,
                                    cfg=DP_CFG, world=mesh.world,
                                    rank=mesh.rank)
        fresh, at = restore_checkpoint(str(ckpt), fresh)
        assert at == 2
        restored = {"digest": fresh.digest(),
                    "residual": fresh.residual_digest()}
        resumed, last, _ = run_case(mesh, params, batches[2:], tcfg,
                                    state=fresh)
        out.update({f"{name}/straight/{k}": v for k, v in
                    case_record(straight, losses, []).items()})
        out.update({f"{name}/resumed/{k}": v for k, v in
                    case_record(resumed, first + last, []).items()})
        out[f"{name}/restored_digest"] = np.asarray(restored["digest"])
        out[f"{name}/restored_residual"] = np.asarray(
            str(restored["residual"]))
        out[f"{name}/saved_digest"] = np.asarray(state.digest())
        out[f"{name}/saved_residual"] = np.asarray(
            str(state.residual_digest()))
        mesh.barrier()
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **out)


def save_batches(path, n: int, seed: int = 0) -> list:
    """``n`` seeded global batches (``dp_batch``) in one ``.npz``."""
    batches = [dp_batch(seed + i) for i in range(n)]
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches)
                      for k, v in b.items()})
    return batches


REF_STEP_CODE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, smoke_variant
from repro.configs.base import TrainConfig, InputShape
from repro.core.amp import make_policy
from repro.core.compat import make_mesh
from repro.train.checkpoint import save_checkpoint
from repro.train.train_step import init_train_state, make_train_step_dp
cfg = smoke_variant(get_config("bert-large"), d_model=64)
params = jax.tree_util.tree_map(
    jnp.asarray, np.load(sys.argv[1], allow_pickle=True)["params"].item())
data = dict(np.load(sys.argv[2]))
n = len({k.split("/")[0] for k in data})
batches = [{k.split("/")[1]: jnp.asarray(v) for k, v in data.items()
            if k.split("/")[0] == str(i)} for i in range(n)]
shape = InputShape("t", %(seq)d, %(batch)d, "train")
world = len(jax.devices())
mesh = make_mesh((world,), ("data",))
out = {}
for name, kw in json.loads(sys.argv[4]).items():
    tcfg = TrainConfig(precision="f32", accum_steps=kw["accum"],
                       collective_strategy=kw["strategy"],
                       overlap_exchange=kw["overlap"],
                       grad_compression=kw["comp"],
                       bucket_bytes=kw["bucket_bytes"], total_steps=50,
                       warmup_steps=2)
    step, _ = make_train_step_dp(cfg, tcfg, mesh, shape)
    state = init_train_state(params, make_policy("f32"), tcfg, world=world)
    losses = []
    for i, b in enumerate(batches):
        state, m = step(state, b)
        losses.append(float(np.asarray(m["loss"])))
        if kw.get("save_at") == i + 1:
            save_checkpoint(sys.argv[3] + "/" + name, i + 1, state)
    out[name + "/losses"] = np.asarray(losses)
np.savez(sys.argv[3] + "/ref.npz", **out)
print("OK")
""" % {"seq": DP_SEQ, "batch": DP_BATCH}


def run_steps(tmp: Path, params: dict, n_batches: int, world: int, pods: int,
              rank_fn, port_cases, ref_cases: dict):
    """The reference's ``make_train_step_dp`` over ``ref_cases`` ({name:
    step_case keywords, plus "save_at" for a checkpoint}) on ``world``
    forced host devices, and at the same time ``rank_fn`` over
    ``port_cases`` on ``world`` gloo ranks in ``pods`` pods.  Returns
    (reference outputs, [the port's outputs a rank])."""
    np.savez(tmp / "params.npz", params=np.asarray(params, dtype=object))
    save_batches(tmp / "batches.npz", n_batches)
    files = [str(tmp / "params.npz"), str(tmp / "batches.npz")]
    full = {name: dict(dict(accum=2, overlap=False, comp="none",
                            bucket_bytes=2 ** 16), **kw)
            for name, kw in ref_cases.items()}
    ref = run_reference(REF_STEP_CODE, [*files, tmp, json.dumps(full)],
                        world)
    try:
        M.spawn(rank_fn, world, args=(*files, str(tmp), tuple(port_cases)),
                device="cpu", pods=pods, timeout_s=60, wait_s=240)
    except BaseException:
        ref.kill()
        raise
    finish_reference(ref)
    return (dict(np.load(tmp / "ref.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)])


def residual_loop_rank(mesh, case, out_dir):
    """``train_loop`` at world 2 over a state with a residual (one leaf of
    4 elements; a finite step adds r + 1 to rank r's, a non-finite step
    holds it, as the compressed exchange does): "one_rank_error" raises on
    rank 1 alone at step 2, after the exchange; "budget" makes every step
    after the first non-finite with a budget of 1, so every rank aborts at
    step 3; "transient" injects ``TransientStepError`` at step 2 on every
    rank more often than it is retried.  Writes the rank's outcome and the
    warnings it logged."""
    import logging
    from repro_torch.train.faults import FaultInjector, FaultPlan
    from repro_torch.train.trainer import train_loop

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    logging.getLogger("repro_torch.train").addHandler(Keep())
    tcfg = TrainConfig(precision="f32", grad_compression="int8")
    state = ts.init_train_state({"w": torch.zeros(4)}, make_policy("f32"),
                                tcfg, cfg=None, world=mesh.world,
                                rank=mesh.rank)

    def step(state, batch):
        C.psum(torch.ones(1), mesh.group)
        if case == "one_rank_error" and mesh.rank == 1 and batch == 2:
            raise RuntimeError(f"rank {mesh.rank} fails after the exchange")
        if case == "budget" and batch > 1:
            return state, {"loss": float("nan")}
        state.err = {p: e + mesh.rank + 1 for p, e in state.err.items()}
        return state, {"loss": 1.0}

    ckpt = Path(out_dir) / case
    result = {"error": None}
    try:
        train_loop(step, state, iter(range(1, 5)), total_steps=4,
                   log_every=1, ckpt_dir=str(ckpt), ckpt_every=100,
                   max_consecutive_skips=1, max_retries=1,
                   retry_backoff_s=0.0, mesh=mesh,
                   faults=FaultInjector(FaultPlan(fail_at=2, fail_count=3)
                                        if case == "transient" else
                                        FaultPlan()))
    except Exception as e:  # noqa: BLE001 -- the outcome is the result
        result["error"] = type(e).__name__
    result["warnings"] = records
    (Path(out_dir) / f"{case}_rank{mesh.rank}.json").write_text(
        json.dumps(result))


# ---------------------------------------------------------------------------
# the decoder trainer's CLI on gloo ranks (``tests/test_torch_rwkv_train.py``)
# ---------------------------------------------------------------------------

def train_cli_rank(mesh, argv, out_dir):
    """``launch/train.py`` with ``argv`` (which holds ``--dp``) on this
    rank of ``mesh``: writes the rank's state digest and loss bits."""
    from repro_torch.launch import train as TR
    args = TR.parse_args(list(argv))
    _, state, history = TR._train(args, TR.model_config(args), mesh)
    (Path(out_dir) / f"cli_rank{mesh.rank}.json").write_text(json.dumps(
        {"digest": state.digest(),
         "losses": [r["loss"].hex() for r in history]}))
