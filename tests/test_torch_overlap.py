"""The port's overlapped drain (``core/grad_accum.py``,
``collectives.OverlappedReduce``) and its compressed counterpart in
``train/train_step.py`` ``make_train_step_dp``, twins of
``tests/test_overlap.py``.

``smoke_variant(bert-large, d_model=64)`` in f32 from the reference's
seeded weights (``bridge``), seeded global batches of 16 x 32 tokens, 4
gloo ranks in 2 pods (``torch_dp_workers.overlap_rank``):

* ``:129``: 3 steps of the overlapped drain give the serial schedule's
  losses and state in bits under psum at accumulation 1, 2 and 4, under
  bucketed, ring and hierarchical at 2, and with the uneven bucket size
  50021 (buffers straddling bucket boundaries) -- by construction, as each
  bucket is exchanged in the serial path's own layout;
* ``:172``: int8 with the overlapped drain gives int8 serial's bits, the
  residuals included (its resume, and the losses against the reference's
  ``make_train_step_dp``, are ``tests/test_torch_compression_resume.
  py``'s);
* every rank starts the drain's buckets in the same order, each bucket
  once;
* ``:242``: ``overlapped_reduce_tree`` (pre-scale 0.5, world 4) against
  the serial reduce, in bits, under each strategy;
* ``:274``: the single-card step refuses overlap (in
  ``tests/test_torch_compression.py``, with compression's refusal)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import collectives as C
from repro_torch.launch import mesh as M
from test_torch_dp import reference_params

import torch_dp_workers as W
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

SERIAL_VS_OVERLAP = (
    [dict(strategy="psum", accum=a) for a in (1, 2, 4)]
    + [dict(strategy=s) for s in ("bucketed", "ring", "hierarchical")]
    + [dict(strategy="bucketed", bucket_bytes=50021),
       dict(strategy="psum", comp="int8")])
UNEVEN = dict(strategy="psum", bucket_bytes=50021)   # vs psum serial
STEPS = 3


def _name(kw, overlap):
    return W.case_name(**dict(kw, overlap=overlap))


def _serial(kw):
    """The serial case an overlapped case is held to."""
    return _name(dict(kw, bucket_bytes=2 ** 16) if kw is UNEVEN else kw,
                 False)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap")
    np.savez(tmp / "params.npz",
             params=np.asarray(reference_params(), dtype=object))
    W.save_batches(tmp / "batches.npz", STEPS)
    cases = [dict(kw, overlap=o) for kw in SERIAL_VS_OVERLAP
             for o in (False, True)] + [dict(UNEVEN, overlap=True)]
    M.spawn(W.overlap_rank, 4,
            args=(str(tmp / "params.npz"), str(tmp / "batches.npz"),
                  str(tmp), tuple(cases)),
            device="cpu", pods=2, timeout_s=60, wait_s=240)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("kw", SERIAL_VS_OVERLAP + [UNEVEN],
                         ids=lambda kw: _name(kw, True))
def test_overlap_has_the_serial_bits(port, kw):
    serial, overlap = _serial(kw), _name(kw, True)
    for r, got in enumerate(port):
        assert got[f"{overlap}/losses"].tolist() == \
            got[f"{serial}/losses"].tolist(), (r, kw)
        assert str(got[f"{overlap}/digest"]) == str(got[f"{serial}/digest"])
        if kw.get("comp", "none") != "none":
            assert str(got[f"{overlap}/residual_digest"]) == \
                str(got[f"{serial}/residual_digest"]), r
            assert float(got[f"{overlap}/residual_max"]) > 0
        assert np.all(np.isfinite(got[f"{overlap}/losses"]))
        assert str(got[f"{overlap}/digest"]) == \
            str(port[0][f"{overlap}/digest"])


@pytest.mark.parametrize("kw", SERIAL_VS_OVERLAP + [UNEVEN],
                         ids=lambda kw: _name(kw, True))
def test_every_rank_starts_the_buckets_in_one_order(port, kw):
    """The uncompressed drain starts every bucket once, in one order on
    every rank; the compressed drain (its global finite flag needs every
    buffer) and the serial schedule start none during the backward."""
    name = _name(kw, True)
    orders = [json.loads(str(got[f"{name}/orders"])) for got in port]
    assert all(o == orders[0] for o in orders)
    for order in orders[0]:
        if kw.get("comp", "none") != "none":
            assert order is None
        else:
            assert order and sorted(order) == list(range(len(order)))
    serial = json.loads(str(port[0][f"{_serial(kw)}/orders"]))
    assert serial == [None] * STEPS


def _tree_rank(mesh, out_dir):
    """``:242`` on this rank: three buffers of seeded rows."""
    rng = np.random.default_rng(242)
    rows = {k: rng.standard_normal((4, n)).astype(np.float32)
            for k, n in (("a", 37), ("b", 15), ("c", 211))}
    out = {}
    for strategy in C.STRATEGIES:
        tree = [torch.from_numpy(v[mesh.rank].copy()) for v in rows.values()]
        packed = C.overlapped_reduce_tree(tree, strategy=strategy, mesh=mesh,
                                          bucket_bytes=256, world=4,
                                          pre_scale=0.5)
        want = [x.mul_(0.5) for x in
                (torch.from_numpy(v[mesh.rank].copy()) for v in rows.values())]
        if strategy == "bucketed":
            want = C.bucketed_psum_tree(want, mesh.group, bucket_bytes=256)
        else:
            want = C.reduce_gradients(want, strategy=strategy, mesh=mesh)
        for k, p, w in zip(rows, packed, [x.div_(4) for x in want]):
            out[f"{strategy}/{k}/packed"] = p.numpy()
            out[f"{strategy}/{k}/serial"] = w.numpy()
    np.savez(f"{out_dir}/tree{mesh.rank}.npz", **out)


def test_overlapped_reduce_tree_matches_the_serial_reduce(tmp_path):
    M.spawn(_tree_rank, 4, args=(str(tmp_path),), device="cpu", pods=2,
            timeout_s=60, wait_s=120)
    for r in range(4):
        got = np.load(tmp_path / f"tree{r}.npz")
        for k in (k for k in got.files if k.endswith("/packed")):
            np.testing.assert_array_equal(got[k],
                                          got[k[:-len("packed")] + "serial"],
                                          err_msg=f"rank {r} {k}")
