"""Does the data-parallel step keep every rank the same and every strategy
the same?  Spawns ranks of ``torch.distributed`` and runs one BERT step
under each of the four gradient-exchange strategies.

  PYTHONPATH=src python -m repro_torch.launch.dp_check \
      [--world 4] [--pods 2] [--backend nccl|gloo] [--share-device] \
      [--full-width | --d-model 128] [--device cuda|cpu] [--batch 128] \
      [--timeout 300]

From one state of seed 0 (``launch/pretrain_bert.py``'s weights) and one
global batch (the first phase-1 batch of 128 tokens that ``pretrain_bert
--batch N`` feeds, the corpus sharded as it shards it), every rank runs
one bf16 step with accumulation 2 of ``make_train_step_dp`` under psum,
ring, hierarchical (``--pods`` pods; psum at one pod) and bucketed, each
from a fresh state.
It checks, and exits non-zero unless all hold:

* every rank's state after each step has the same bits (its
  ``TrainState.digest``: masters, moments, step, loss scale);
* each strategy's masters agree with psum's within rtol 1e-5, atol 1e-6,
  and its loss within rtol 1e-5 (the reference's own check,
  ``tests/test_multidevice.py:114-116``);
* on the card, every kernel of a phase-1 training step launched on every
  rank (the flash backward's post-pass runs only over more than one
  128-key tile, so not at phase 1).

It logs each strategy's exchange seconds on each rank (the step's own
``exchange_s``: CUDA events around its reduces and divisions of the
gradients and the loss on the card, the host clock on the CPU) beside
``exchange_bytes_per_step``, the step's seconds and each rank's peak
device memory, and prints one JSON line of all of it last.

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
PRECISION, ACCUM, SEED = "bf16", 2, 0


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
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective waits for its peers")
    ap.set_defaults(full_depth=False)     # read by model_config
    return ap.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _vs(got: dict, base: dict) -> dict:
    """Elements of ``got`` outside MASTER_TOL of ``base``, and the largest
    absolute difference, over every group."""
    bad, worst = 0, 0.0
    for p, b in base.items():
        d = (got[p] - b).abs()
        bad += int((d > MASTER_TOL["atol"] + MASTER_TOL["rtol"]
                    * b.abs()).sum())
        worst = max(worst, float(d.max()))
    return {"outside_tol": bad, "max_abs": worst}


def check_rank(mesh, args, data_dir, out_path):
    """One step under each strategy on this rank; every rank checks the
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
    records, base_master, base_loss = {}, None, None
    for strategy in C.STRATEGIES:
        tcfg = TrainConfig(precision=PRECISION, accum_steps=ACCUM,
                           collective_strategy=strategy, optimizer="lamb",
                           learning_rate=phase.learning_rate * 20,
                           total_steps=phase.steps,
                           warmup_steps=max(2, phase.steps // 10))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        state = init_train_state(api.init_params(cfg, seed=SEED, device=dev),
                                 policy, tcfg)
        step = make_train_step_dp(cfg, tcfg, mesh)
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
        if strategy == "psum":
            base_master = {p: t.clone() for p, t in state.opt.master.items()}
            base_loss = loss
        vs = _vs(state.opt.master, base_master)
        mine = {"digest": state.digest(), "loss": loss,
                "skipped": bool(m["skipped"]), "step_s": step_s,
                "exchange_s": step.exchange_s, "peak_gib": peak,
                "vs_psum": vs,
                "launches": {k: launches[k] for k in PHASE1_KERNELS}}
        n_params = sum(g.numel() for g in state.opt.master.values())
        del state, m
        ranks = mesh.gather_objects(mine)
        rec = {"loss": loss, "loss_vs_psum": abs(loss - base_loss)
               / abs(base_loss), "digests_equal": len(
                   {r["digest"] for r in ranks}) == 1,
               "digest": ranks[0]["digest"], "n_params": n_params,
               "exchange_bytes": C.exchange_bytes_per_step(
                   n_params, strategy=strategy, world=mesh.world,
                   pod=mesh.pods if strategy == "hierarchical" else 1,
                   bucket_bytes=tcfg.bucket_bytes),
               "ranks": [{k: r[k] for k in ("step_s", "peak_gib",
                                            "exchange_s", "vs_psum",
                                            "launches", "skipped")}
                         for r in ranks]}
        records[strategy] = rec
        _check(strategy, rec, dev)
        if mesh.rank:
            continue
        logger.info(
            "%s: loss %r (vs psum %.3g), digests equal %s, masters vs psum "
            "%s, step %s s, exchange %s s a rank (%.4g GB a rank by "
            "exchange_bytes_per_step), peak %s GiB", strategy, loss,
            rec["loss_vs_psum"], rec["digests_equal"], ranks[0]["vs_psum"],
            [round(r["step_s"], 3) for r in ranks],
            [round(r["exchange_s"], 4) for r in ranks],
            rec["exchange_bytes"] / 1e9,
            [None if r["peak_gib"] is None else round(r["peak_gib"], 2)
             for r in ranks])
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


def _check(strategy, rec, dev) -> None:
    if not rec["digests_equal"]:
        raise AssertionError(f"{strategy}: the ranks' states differ")
    if rec["loss_vs_psum"] > LOSS_RTOL:
        raise AssertionError(f"{strategy}: loss {rec['loss']} is "
                             f"{rec['loss_vs_psum']:.3g} from psum's")
    for r, rank in enumerate(rec["ranks"]):
        if rank["vs_psum"]["outside_tol"]:
            raise AssertionError(f"{strategy}: rank {r}'s masters vs psum's "
                                 f"{rank['vs_psum']}")
        if rank["skipped"]:
            raise AssertionError(f"{strategy}: rank {r} skipped the step")
        missed = [k for k, n in rank["launches"].items() if n <= 0]
        if dev.type == "cuda" and missed:
            raise AssertionError(f"{strategy}: rank {r} never launched "
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
