"""The port's gradient-exchange collectives (``repro_torch/core/
collectives.py``) against the reference's (``repro/core/collectives.py``),
twins of ``tests/test_multidevice.py:9``, ``:201`` and ``:239``.

The reference runs in one subprocess over 8 forced host devices
(``conftest.run_multidevice``'s environment); the port runs as 8 gloo
ranks (``launch.mesh.spawn``, a ``file://`` store, a timeout on the
process group and on the ranks), both at once.  The inputs are seeded
numpy float32 rows, one a device or rank, so the order of the sums shows:

* the ring at sizes 40, 37 (padded), 5 (fewer elements than ranks) and 1,
  and over a flattened (2, 4) mesh: the reference's bits, since the port
  adds the chunks in the reference's order by construction;
* hierarchical over (pod 2, fast 4) at 36 (the reduce-scatter path) and 37
  (the one fused all-reduce), and bucketed at 64 bytes (three small leaves
  in one bucket, two alone): within rtol 1e-6 of the reference;
* psum and every strategy of ``reduce_gradients`` against a numpy sum
  (rtol 1e-6), every rank holding the same bits.

Also ``bucket_leaves`` over the port's gradient buffers against the
reference's over its gradient tree, and ``exchange_bytes_per_step``."""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from conftest import SRC
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core import collectives as JC
from repro.models import api as japi
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import collectives as C
from repro_torch.launch import mesh as M
from repro_torch.utils import LeafGroups

import torch_dp_workers as W
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

REF_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.compat import make_mesh, shard_map
from repro.core.collectives import (ring_all_reduce, hierarchical_psum,
                                    reduce_gradients)
data = dict(np.load(sys.argv[1]))
out = {}
row = P("d", None)
mesh = make_mesh((8,), ("d",))
for size in %(ring)r:
    out[f"ring{size}"] = jax.jit(shard_map(
        lambda v: ring_all_reduce(v, "d"), mesh=mesh, in_specs=row,
        out_specs=row))(data[f"ring{size}"])
mesh2 = make_mesh((2, 4), ("data", "model"))
rows2 = P(("data", "model"), None)
out["ring_2axis"] = jax.jit(shard_map(
    lambda v: ring_all_reduce(v, ("data", "model")), mesh=mesh2,
    in_specs=rows2, out_specs=rows2, check_vma=False))(data["ring_2axis"])
mesh3 = make_mesh((2, 4), ("pod", "d"))
rows3 = P(("pod", "d"), None)
for size in %(hier)r:
    out[f"hier{size}"] = jax.jit(shard_map(
        lambda v: hierarchical_psum(v, "d", "pod"), mesh=mesh3,
        in_specs=rows3, out_specs=rows3,
        check_vma=False))(data[f"hier{size}"])
tree = {k: data[f"bucket_{k}"] for k in %(leaves)r}
red = jax.jit(shard_map(
    lambda t: reduce_gradients(t, strategy="bucketed", data_axes=("d",),
                               pod_axis="pod", bucket_bytes=64),
    mesh=mesh3, in_specs=rows3, out_specs=rows3))(tree)
out.update({f"bucket_{k}": v for k, v in red.items()})
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("OK")
""" % {"ring": W.RING_SIZES, "hier": W.HIER_SIZES,
       "leaves": sorted(W.BUCKET_LEAVES)}

RING_CASES = [f"ring{s}" for s in W.RING_SIZES] + ["ring_2axis"]
TOL_CASES = [f"hier{s}" for s in W.HIER_SIZES] + [
    f"bucket_{k}" for k in sorted(W.BUCKET_LEAVES)]
STRATEGY_CASES = ["psum"] + [f"reduce_{s}" for s in C.STRATEGIES]


def _inputs(rng):
    data = {f"ring{s}": rng.standard_normal((8, s)) for s in W.RING_SIZES}
    data["ring_2axis"] = rng.standard_normal((8, 11))
    data.update({f"hier{s}": rng.standard_normal((8, s))
                 for s in W.HIER_SIZES})
    data.update({f"bucket_{k}": rng.standard_normal((8, n))
                 for k, n in W.BUCKET_LEAVES.items()})
    data["psum"] = rng.standard_normal((8, 29))
    data["reduce"] = rng.standard_normal((8, 13))
    return {k: (v * 100).astype(np.float32) for k, v in data.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, the port's (8, ...) rows)."""
    tmp = tmp_path_factory.mktemp("collectives")
    data = _inputs(np.random.default_rng(21))
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_CODE), str(tmp / "in.npz"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        M.spawn(W.collectives_rank, 8, args=(str(tmp / "in.npz"), str(tmp)),
                device="cpu", pods=2, timeout_s=60, wait_s=240)
        out, _ = ref.communicate(timeout=240)
    finally:
        ref.kill()
    assert ref.returncode == 0 and "OK" in out, out
    ranks = [np.load(tmp / f"rank{r}.npz") for r in range(8)]
    port = {k: np.concatenate([r[k] for r in ranks]) for k in ranks[0].files}
    return data, dict(np.load(tmp / "ref.npz")), port


def _same_on_every_rank(rows):
    assert all(np.array_equal(rows[0], r) for r in rows[1:])


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_has_the_reference_bits(runs, case):
    data, ref, port = runs
    _same_on_every_rank(port[case])
    np.testing.assert_array_equal(port[case], ref[case], err_msg=case)
    np.testing.assert_allclose(port[case][0], data[case].sum(0, np.float64),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("case", TOL_CASES)
def test_hierarchical_and_bucketed_match_the_reference(runs, case):
    data, ref, port = runs
    _same_on_every_rank(port[case])
    np.testing.assert_allclose(port[case], ref[case], rtol=1e-6, atol=1e-4,
                               err_msg=case)


@pytest.mark.parametrize("case", STRATEGY_CASES)
def test_every_strategy_is_the_sum(runs, case):
    data, _, port = runs
    src = "psum" if case == "psum" else "reduce"
    _same_on_every_rank(port[case])
    want = np.tile(data[src].sum(0, np.float64), (8, 1))
    np.testing.assert_allclose(port[case], want, rtol=1e-6, atol=1e-4,
                               err_msg=case)


@pytest.mark.parametrize("bucket_bytes", [25 * 2 ** 20, 2 ** 16, 64])
def test_bucket_leaves_match_the_reference(bucket_bytes):
    """The port's flat gradient buffers (``LeafGroups.paths`` order) fall
    into the reference's buckets of its gradient tree."""
    jcfg = jsmoke(jget_config("bert-large"), d_model=64)
    cfg = smoke_variant(get_config("bert-large"), d_model=64)
    jparams = jax.jit(lambda key: japi.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(0))
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    groups = LeafGroups(params)
    bufs = list(groups.flatten(params).values())
    assert len(bufs) == len(jax.tree_util.tree_leaves(jparams)) == 26
    want = JC.bucket_leaves(jparams, bucket_bytes)
    assert C.bucket_leaves(bufs, bucket_bytes) == want
    assert len(want) > 1 or bucket_bytes == 25 * 2 ** 20


def test_exchange_bytes_per_step_matches_the_reference():
    for strategy in C.STRATEGIES:
        for compression in ("none", "fp16", "int8"):
            for world, pod in ((1, 1), (2, 1), (4, 1), (4, 2), (8, 2),
                               (8, 4), (16, 4)):
                for n, bucket in ((1000, 64), (336_000_000, 25 * 2 ** 20)):
                    kw = dict(strategy=strategy, compression=compression,
                              world=world, pod=pod, bucket_bytes=bucket)
                    assert C.exchange_bytes_per_step(n, **kw) == \
                        JC.exchange_bytes_per_step(n, **kw), (n, kw)


def test_reduce_gradients_refuses_an_unknown_strategy():
    with pytest.raises(ValueError, match="unknown collective strategy"):
        C.reduce_gradients([], strategy="allgather",
                           mesh=M.single_mesh("cpu"))
    # world 1 without a process group: nothing to exchange
    x = np.arange(5, dtype=np.float32)
    t = torch.from_numpy(x.copy())
    for s in C.STRATEGIES:
        assert C.reduce_gradients([t], strategy=s,
                                  mesh=M.single_mesh("cpu"))[0] is t
    np.testing.assert_array_equal(t.numpy(), x)


def test_the_mesh_refuses_what_it_cannot_do_as_asked(tmp_path, monkeypatch):
    """No silent fallback: NCCL is not swapped for gloo, ranks do not share
    a card unless asked, and nothing is joined without its ranks."""
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(ValueError, match="NCCL needs one card a rank"):
        M.init_mesh("cpu", backend="nccl", rank=0, world=1,
                    init_method=store)
    with pytest.raises(ValueError, match="NCCL needs one card a rank"):
        M.init_mesh("cpu", backend="nccl", share_device=True, rank=0,
                    world=1, init_method=store)
    with pytest.raises(ValueError, match="not a multiple of pods"):
        M.init_mesh("cpu", pods=3, rank=0, world=4, init_method=store)
    with pytest.raises(ValueError, match="needs world and init_method"):
        M.init_mesh("cpu", rank=0)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="not set"):
        M.init_mesh("cpu")
    with pytest.raises(ValueError, match="name the type"):
        M.single_mesh("cuda:1")
    assert not torch.distributed.is_initialized()
    mesh = M.single_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.group, mesh.staged) == \
        (0, 1, None, False)
