"""Does the data-parallel step keep every rank the same and every
exchange the same?  Spawns ranks of ``torch.distributed`` and runs one
BERT step under each of the gradient exchange's cases.

  PYTHONPATH=src python -m repro_torch.launch.dp_check \
      [--world 4] [--pods 2] [--backend nccl|gloo] [--share-device] \
      [--full-width | --d-model 128] [--device cuda|cpu] [--batch 128] \
      [--cases psum ring hierarchical bucketed hierarchical+fp16 \
               psum+int8 bucketed+overlap psum+int8+overlap] \
      [--timeout 300]

A case is a strategy (psum, ring, hierarchical, bucketed), with ``+fp16``
or ``+int8`` for the compressed exchange and ``+overlap`` for the
overlapped drain; the default is the four strategies.  psum runs first
whatever the list, the case the others are held to.  From one state of
seed 0 (``launch/pretrain_bert.py``'s weights) and one global batch (the
first phase-1 batch of 128 tokens that ``pretrain_bert --batch N``
feeds, the corpus sharded as it shards it), every rank runs one bf16 step
with accumulation 2 of ``make_train_step_dp`` under each case
(hierarchical over ``--pods`` pods; psum at one pod), each from a fresh
state.  It checks, and exits non-zero unless all hold:

* every rank's replicated state after each step has the same bits (its
  ``TrainState.digest``: masters, moments, step, loss scale);
* each uncompressed case's masters agree with psum's within rtol 1e-5,
  atol 1e-6, and every case's loss within rtol 1e-5 (the reference's own
  check, ``tests/test_multidevice.py:114-116``);
* a compressed case's mean gradients (the ones the clip takes) agree with
  psum's within the reference's tolerances (``tests/test_compression.py``:
  fp16 1e-3, int8 5e-2, relative and of the largest magnitude, here of
  each exchange bucket), and each rank's residual is nonzero and differs
  from every other rank's;
* an overlapped case has the bits of its serial case (when that case
  ran): the same state digest and, compressed, the same residuals; and
  every rank started its buckets in the same order;
* on the card, every kernel of a phase-1 training step launched on every
  rank (the flash backward's post-pass runs only over more than one
  128-key tile, so not at phase 1).

It logs each case's exchange seconds on each rank (the step's own
``exchange_s``: CUDA events around its exchange of the gradients and the
loss on the card, the host clock on the CPU) beside
``exchange_bytes_per_step`` for that compression, the seconds of local
quantise and dequantise work within it on a line of their own, the step's
seconds and each rank's peak device memory, and prints one JSON line of
all of it last.

The ranks are processes of this host over a ``file://`` store.  NCCL needs
a card a rank; ``--backend gloo --share-device`` lets every rank share one
card, each exchange then staged through host memory (``core/
collectives.py``): its seconds are a reading of that path, not of NCCL or
of a network.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import collectives as C
from repro_torch.core.amp import make_policy
from repro_torch.data.pipeline import ShardedLoader, prepare_bert_data
from repro_torch.kernels import build, ops
from repro_torch.launch import mesh as M
from repro_torch.launch.pretrain_bert import model_config
from repro_torch.models import api
from repro_torch.train.phases import bert_phases
from repro_torch.train.train_step import init_train_state, make_train_step_dp

logger = logging.getLogger("repro_torch.dp_check")

# the kernels a phase-1 training step launches
PHASE1_KERNELS = ("flash_fwd", "flash_bwd_prep", "flash_bwd", "layernorm",
                  "layernorm_bwd", "bias_gelu", "bias_gelu_bwd",
                  "lamb_moments")
MASTER_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
# compressed mean gradients vs psum's, relative and of the bucket's max
GRAD_TOL = {"fp16": 1e-3, "int8": 5e-2}
PRECISION, ACCUM, SEED = "bf16", 2, 0


def parse_case(case: str):
    """"psum+int8+overlap" -> ("psum", "int8", True)."""
    strategy, *mods = case.split("+")
    comp = [m for m in mods if m in ("fp16", "int8")]
    if strategy not in C.STRATEGIES or len(comp) > 1 or any(
            m not in ("fp16", "int8", "overlap") for m in mods):
        raise ValueError(f"dp_check: unknown case {case!r}")
    return strategy, comp[0] if comp else "none", "overlap" in mods


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--share-device", action="store_true",
                    help="let ranks share cards (gloo only)")
    ap.add_argument("--full-width", action="store_true",
                    help="bert-large as published (else 2 layers)")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--cases", nargs="+", default=list(C.STRATEGIES),
                    help="strategy[+fp16|+int8][+overlap] each (psum "
                    "always runs first)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective waits for its peers")
    ap.set_defaults(full_depth=False)     # read by model_config
    args = ap.parse_args(argv)
    for case in args.cases:
        parse_case(case)
    args.cases = ["psum"] + [c for c in dict.fromkeys(args.cases)
                             if c != "psum"]
    return args


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _vs(got: dict, base: dict) -> dict:
    """Elements of ``got`` outside MASTER_TOL of ``base`` (on the host; a
    group at a time on ``got``'s device), and the largest absolute
    difference, over every group."""
    bad, worst = 0, 0.0
    for p, b in base.items():
        b = b.to(got[p].device)
        d = (got[p] - b).abs()
        bad += int((d > MASTER_TOL["atol"] + MASTER_TOL["rtol"]
                    * b.abs()).sum())
        worst = max(worst, float(d.max()))
    return {"outside_tol": bad, "max_abs": worst}


def _vs_grads(got: dict, base: dict, tol: float, buckets, dev) -> dict:
    """Elements of ``got`` farther from ``base`` than ``tol`` x (|base| +
    the largest |base| of its bucket), and the largest such ratio; both on
    the host, each group compared on ``dev``."""
    bad, worst = 0, 0.0
    for bucket in buckets:
        scale = max(float(base[p].abs().max()) for p in bucket)
        for p in bucket:
            want = base[p].to(dev)
            d = (got[p].to(dev) - want).abs()
            bad += int((d > tol * (scale + want.abs())).sum())
            worst = max(worst, float(d.max()) / max(scale, 1e-30))
    return {"outside_tol": bad, "max_abs_over_max": worst}


def check_rank(mesh, args, data_dir, out_path):
    """One step under each case on this rank; every rank checks the
    gathered records the same way, so all fail together."""
    logging.basicConfig(level=logging.INFO, format=f"[%(levelname)s "
                        f"%(name)s rank {mesh.rank}] %(message)s")
    logger.info("%s", mesh.describe())
    cfg = model_config(args)
    policy = make_policy(PRECISION)
    phase = bert_phases(10, scale_batch=args.batch / 4096)[0]
    loader = ShardedLoader(str(data_dir), worker=0, n_workers=1,
                           batch=phase.global_batch, seed=SEED)
    batch = api.to_device(next(loader), mesh.device)
    dev = mesh.device
    records, base, base_loss = {}, None, None
    for case in args.cases:
        strategy, comp, overlap = parse_case(case)
        tcfg = TrainConfig(precision=PRECISION, accum_steps=ACCUM,
                           collective_strategy=strategy,
                           grad_compression=comp, overlap_exchange=overlap,
                           optimizer="lamb",
                           learning_rate=phase.learning_rate * 20,
                           total_steps=phase.steps,
                           warmup_steps=max(2, phase.steps // 10))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        state = init_train_state(api.init_params(cfg, seed=SEED, device=dev),
                                 policy, tcfg, world=mesh.world,
                                 rank=mesh.rank)
        step = make_train_step_dp(cfg, tcfg, mesh,
                                  keep_grads=case == "psum" or comp != "none")
        ops.reset_launch_counts()
        mesh.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        _sync(dev)
        step_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        loss = float(m["loss"])
        peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else None)
        if case == "psum":
            # psum's state waits on the host (the card holds 4 ranks)
            base = {"master": {p: t.cpu()
                               for p, t in state.opt.master.items()},
                    "grads": step.grads}
            base_loss = loss
        paths = state.opt.groups.paths
        mine = {"digest": state.digest(), "loss": loss,
                "skipped": bool(m["skipped"]), "step_s": step_s,
                "exchange_s": step.exchange_s,
                "compress_s": step.compress_s, "peak_gib": peak,
                "vs_psum": _vs(state.opt.master, base["master"]),
                "bucket_order": step.bucket_order,
                "launches": {k: launches[k] for k in PHASE1_KERNELS}}
        if comp != "none":
            mine["residual_digest"] = state.residual_digest()
            mine["residual_max"] = max(float(e.abs().max())
                                       for e in state.err.values())
            mine["grads_vs_psum"] = _vs_grads(
                step.grads, base["grads"], GRAD_TOL[comp],
                [[paths[i] for i in b] for b in C.bucket_leaves(
                    [base["grads"][p] for p in paths], tcfg.bucket_bytes)],
                dev)
        n_params = sum(g.numel() for g in state.opt.master.values())
        del state, m, step
        ranks = mesh.gather_objects(mine)
        rec = {"strategy": strategy, "compression": comp, "overlap": overlap,
               "loss": loss, "loss_vs_psum": abs(loss - base_loss)
               / abs(base_loss), "digests_equal": len(
                   {r["digest"] for r in ranks}) == 1,
               "digest": ranks[0]["digest"], "n_params": n_params,
               "exchange_bytes": C.exchange_bytes_per_step(
                   n_params, strategy=strategy, compression=comp,
                   world=mesh.world,
                   pod=mesh.pods if strategy == "hierarchical" else 1,
                   bucket_bytes=tcfg.bucket_bytes),
               "ranks": [{k: r[k] for k in r if k != "digest"}
                         for r in ranks]}
        serial = "+".join([strategy] + ([comp] if comp != "none" else []))
        if overlap and serial in records:
            rec["serial_bits"] = rec["digest"] == records[serial]["digest"]\
                and [r.get("residual_digest") for r in ranks] == [
                    r.get("residual_digest")
                    for r in records[serial]["ranks"]]
        records[case] = rec
        _check(case, rec, dev)
        if mesh.rank:
            continue
        logger.info(
            "%s: loss %r (vs psum %.3g), digests equal %s, masters vs psum "
            "%s, step %s s, exchange %s s a rank (%.4g GB a rank by "
            "exchange_bytes_per_step, %s), peak %s GiB%s", case, loss,
            rec["loss_vs_psum"], rec["digests_equal"], ranks[0]["vs_psum"],
            [round(r["step_s"], 3) for r in ranks],
            [round(r["exchange_s"], 4) for r in ranks],
            rec["exchange_bytes"] / 1e9, comp,
            [None if r["peak_gib"] is None else round(r["peak_gib"], 2)
             for r in ranks],
            "" if "serial_bits" not in rec else
            f", the serial case's bits {rec['serial_bits']}")
        if comp != "none":
            logger.info(
                "%s: quantise %s s, dequantise %s s a rank (within the "
                "exchange); gradients vs psum's %s; residual max %s",
                case, [round(r["compress_s"].get("quantise", 0.0), 4)
                       for r in ranks],
                [round(r["compress_s"].get("dequantise", 0.0), 4)
                 for r in ranks], ranks[0]["grads_vs_psum"],
                [r["residual_max"] for r in ranks])
    if mesh.rank == 0:
        Path(out_path).write_text(json.dumps({
            "world": mesh.world, "pods": mesh.pods, "backend": mesh.backend,
            "staged": mesh.staged, "device": str(dev),
            "card": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else None,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "precision": PRECISION, "global_batch": phase.global_batch,
            "seq_len": phase.seq_len, "accum": ACCUM,
            "strategies": records}))


def _check(case, rec, dev) -> None:
    if not rec["digests_equal"]:
        raise AssertionError(f"{case}: the ranks' states differ")
    if rec["loss_vs_psum"] > LOSS_RTOL:
        raise AssertionError(f"{case}: loss {rec['loss']} is "
                             f"{rec['loss_vs_psum']:.3g} from psum's")
    if rec.get("serial_bits") is False:
        raise AssertionError(f"{case}: not the serial case's bits")
    ranks = rec["ranks"]
    if len({str(r["bucket_order"]) for r in ranks}) != 1:
        raise AssertionError(f"{case}: bucket start orders differ: "
                             f"{[r['bucket_order'] for r in ranks]}")
    if rec["compression"] != "none" and len(
            {r["residual_digest"] for r in ranks}) != len(ranks):
        raise AssertionError(f"{case}: two ranks hold the same residual")
    for r, rank in enumerate(ranks):
        if rec["compression"] == "none" and rank["vs_psum"]["outside_tol"]:
            raise AssertionError(f"{case}: rank {r}'s masters vs psum's "
                                 f"{rank['vs_psum']}")
        if rec["compression"] != "none" and (
                rank["grads_vs_psum"]["outside_tol"]
                or not rank["residual_max"] > 0):
            raise AssertionError(f"{case}: rank {r}'s gradients vs psum's "
                                 f"{rank['grads_vs_psum']}, residual max "
                                 f"{rank['residual_max']}")
        if rank["skipped"]:
            raise AssertionError(f"{case}: rank {r} skipped the step")
        missed = [k for k, n in rank["launches"].items() if n <= 0]
        if dev.type == "cuda" and missed:
            raise AssertionError(f"{case}: rank {r} never launched "
                                 f"{missed}")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s %(name)s] %(message)s")
    args = parse_args(argv)
    cfg = model_config(args)
    phase = bert_phases(10, scale_batch=args.batch / 4096)[0]
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("dp_check: --device cuda and no CUDA device")
        t0 = time.perf_counter()
        build.build_all()      # once, before the ranks load the libraries
        logger.info("kernels built in %.1f s", time.perf_counter() - t0)
    if args.share_device:
        # ranks sharing one card: let each one's cache give back what it
        # frees (segments that grow), so the ranks' peaks fit side by side
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="repro_dp_check_") as tmp:
        data_dir = Path(tmp) / phase.name
        prepare_bert_data(str(data_dir), seq_len=phase.seq_len,
                          n_predictions=phase.n_predictions, n_docs=120,
                          vocab_size=cfg.vocab_size, n_shards=4, seed=SEED)
        out_path = Path(tmp) / "result.json"
        M.spawn(check_rank, args.world,
                args=(args, str(data_dir), str(out_path)),
                wait_s=args.timeout * 4, device=args.device, pods=args.pods,
                backend=args.backend, share_device=args.share_device,
                timeout_s=args.timeout)
        result = json.loads(out_path.read_text())
    result["seconds"] = time.perf_counter() - t0
    logger.info("dp_check: %d ranks in %d pods, %s%s, every check held in "
                "%.1f s", args.world, args.pods, result["backend"],
                " (staged through host memory)" if result["staged"] else "",
                result["seconds"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
