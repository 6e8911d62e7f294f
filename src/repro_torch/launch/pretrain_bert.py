"""Two-phase BERT pretraining, the paper's experiment (counterpart of
``examples/pretrain_bert.py``).

  PYTHONPATH=src python -m repro_torch.launch.pretrain_bert \
      [--steps 120] [--d-model 128] [--full-depth] [--full-width] \
      [--batch 16] [--accum 4] [--precision bf16|f32|f16] \
      [--device cuda|cpu] [--workdir DIR] [--seed 0] [--resume] \
      [--loss-log FILE] [--ckpt-every N] [--dp] \
      [--strategy psum|ring|hierarchical|bucketed] \
      [--grad-compression none|fp16|int8] [--overlap] [--bucket-bytes N] \
      [--timing-breakdown]

  PYTHONPATH=src torchrun --standalone --nproc-per-node N \
      -m repro_torch.launch.pretrain_bert --dp [--strategy ring] \
      [--grad-compression int8 --overlap --timing-breakdown] ...

Phase 1 (seq 128, 20 predictions, 90 % of the steps), then phase 2 (seq
512, 80 predictions), on one device: per phase the synthetic corpus is
tokenized and sharded into ``--workdir`` (paper §4.1), a ``ShardedLoader``
feeds global batches of ``--batch`` / 4096 of the paper's, and each step
runs the AMP policy, ``--accum`` micro-batches of fp32 gradient
accumulation and LAMB with fp32 master weights.  The state carries over
from phase 1 to phase 2, as the reference's does (its step count and so its
learning-rate schedule too).  The ``TrainConfig`` of each phase is built as
the example builds it: LAMB at 20x the phase's learning rate, warmup
max(2, steps // 10).

Each phase runs under the supervised loop (``train/trainer.py``
``train_loop``), as the example runs it: checkpoints in
``<workdir>/ckpt/<phase>`` every max(10, steps // 2) steps (or
``--ckpt-every``) and at the end of the phase (the newest 3 kept), a log line every max(1, steps // 10)
steps, the non-finite budget, the watchdog and bounded retry.
``--resume`` restores each phase's newest valid checkpoint with the data
cursor, so a crashed run (``REPRO_FAULTS=crash_at=N``, exit 43) continues
to the losses of an uninterrupted one, bit for bit; a phase already
complete restores its last checkpoint and runs no step.  Give the
resumed run the same ``--steps`` and ``--workdir`` (the step count sets
the phases and their schedules).  ``--loss-log`` appends one JSON line
``{"phase", "step", "loss"}`` a logged step, so a resumed run extends the
crashed run's file.

The model is ``smoke_variant(bert-large, d_model=--d-model)`` with 2
layers, or 24 with ``--full-depth``; ``--full-width`` takes bert-large as
published (24 layers, d_model 1024, 16 heads x 64, d_ff 4096, vocab
30522).  Weights are random, drawn from ``--seed``, as are the corpus and
the loader's shuffles.

``--dp`` is the reference example's pure data parallelism
(``train_step.make_train_step_dp``) with the gradient exchange
``--strategy``.  Under torchrun each process is a rank (``launch/mesh.py``:
NCCL and the card of its ``LOCAL_RANK`` for ``--device cuda``, gloo for
``--device cpu``); without torchrun it runs at world 1 with no process
group and no pod axis, so ``hierarchical`` is psum, as in the example.
Every rank builds the same weights from the seed and reads the same
global batches (``ShardedLoader(worker=0, n_workers=1)``, as the example)
and takes its rows of each; rank 0 prepares the data and writes the
checkpoints, ``--loss-log`` and the per-step log lines, and every rank
logs its final state digest and loss bits last.  The ranks share one
filesystem: every rank reads the data and, on ``--resume``, the
checkpoints that rank 0 wrote under the ``--workdir`` it broadcasts
(``train/trainer.py`` raises when the ranks resume from different
checkpoints).  Without ``--dp``
``--strategy`` is recorded in the ``TrainConfig`` and exchanges nothing,
as in the example.

The flags of the reference's generic trainer (``launch/train.py``) that
its BERT example does not expose, each refused without ``--dp``:
``--grad-compression fp16|int8`` (the compressed exchange with its
error-feedback residual, which the state carries from phase 1 to phase 2
and every checkpoint holds for every rank), ``--overlap`` (the overlapped
drain: each bucket's exchange started during the last micro-batch's
backward, the serial schedule's losses in bits), ``--bucket-bytes`` and
``--timing-breakdown``: at the start of each phase every rank times a
compute twin (the same step with the calibration strategy ``"local"``,
no exchange) and a serial twin (overlap off) as the median of 3 steps
after a warm one on the phase's first batch, each from a copy of the
state (``torch.cuda.synchronize`` around each step on the card), and the
loop then logs ``compute_s``, ``exchange_s`` and ``overlap_frac`` in each
window.  A checkpoint with a residual restored into a run without one (or
the other way round) raises ``ValueError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import statistics
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import TrainConfig
from repro_torch.core import collectives as C
from repro_torch.core.amp import make_policy
from repro_torch.data.pipeline import ShardedLoader, prepare_bert_data
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models import api
from repro_torch.train.phases import bert_phases
from repro_torch.train.train_step import (init_train_state,
                                          make_train_step_dp, train_step_fn)
from repro_torch.train.trainer import train_loop
from repro_torch.utils import tree_count

logger = logging.getLogger("repro_torch.pretrain_bert")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--full-depth", action="store_true",
                    help="24 layers (BERT-large depth) instead of 2")
    ap.add_argument("--full-width", action="store_true",
                    help="bert-large as published (implies full depth)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--accum", type=int, default=4)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="resume each phase from its newest valid "
                         "checkpoint (needs a stable --workdir)")
    ap.add_argument("--loss-log", default=None,
                    help="append {'phase','step','loss'} JSON lines here")
    ap.add_argument("--strategy", default="psum", choices=C.STRATEGIES)
    ap.add_argument("--dp", action="store_true",
                    help="pure data parallelism over torchrun's ranks")
    ap.add_argument("--grad-compression", default="none",
                    choices=C.GRAD_COMPRESSIONS,
                    help="compress the gradient exchange (requires --dp); "
                    "error feedback rides in TrainState and checkpoints")
    ap.add_argument("--overlap", action="store_true",
                    help="overlapped drain exchange (requires --dp): "
                    "per-bucket collectives started inside the last "
                    "micro-batch's backward; losses stay bit-identical to "
                    "the serial schedule")
    ap.add_argument("--bucket-bytes", type=int, default=None,
                    help="gradient exchange bucket size in bytes "
                    "(default: TrainConfig.bucket_bytes)")
    ap.add_argument("--timing-breakdown", action="store_true",
                    help="calibrate compute vs exchange time at the start "
                    "of each phase (times a no-exchange twin + a "
                    "serial-schedule twin) and report compute_s/exchange_s/"
                    "overlap_frac in the log (requires --dp)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="checkpoint every N steps of a phase (default "
                    "max(10, steps // 2))")
    args = ap.parse_args(argv)
    if args.grad_compression != "none" and not args.dp:
        raise SystemExit("--grad-compression requires --dp (the explicit-"
                         "collective data-parallel mode owns the wire "
                         "format)")
    if args.overlap and not args.dp:
        raise SystemExit("--overlap requires --dp (the explicit-collective "
                         "data-parallel mode owns the exchange schedule)")
    if args.timing_breakdown and not args.dp:
        raise SystemExit("--timing-breakdown requires --dp (the twin it "
                         "times against swaps the explicit collective out)")
    return args


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timing_calibration(cfg, tcfg, mesh, policy, state, batch, device,
                       iters: int = 3) -> dict:
    """``{"compute_s", "serial_step_s"}``: the median of ``iters`` steps
    after a warm one of the compute twin (``"local"``: no exchange, no
    compression, no overlap) and of the serial twin (overlap off), each
    from its own copy of ``state``'s weights, on ``batch``, timed as the
    loop times a step (the batch moved to the device, the loss read
    back)."""
    params = state.opt.groups.tree(state.opt.master)

    def median_step_s(twin):
        step = make_train_step_dp(cfg, twin, mesh)
        st = init_train_state(params, policy, twin, world=mesh.world,
                              rank=mesh.rank)
        ts = []
        for i in range(iters + 1):
            _sync(device)
            t0 = time.perf_counter()
            st, m = step(st, api.to_device(batch, device))
            float(m["loss"])
            _sync(device)
            if i:
                ts.append(time.perf_counter() - t0)
        return float(statistics.median(ts))

    compute_s = median_step_s(dataclasses.replace(
        tcfg, collective_strategy="local", grad_compression="none",
        overlap_exchange=False))
    serial_s = median_step_s(dataclasses.replace(tcfg,
                                                 overlap_exchange=False))
    return {"compute_s": compute_s, "serial_step_s": serial_s}


def dp_mesh(args):
    """The ranks of a ``--dp`` run: torchrun's, or world 1 alone."""
    if "WORLD_SIZE" in os.environ:
        return M.init_mesh(args.device)
    return M.single_mesh(args.device)


def model_config(args):
    cfg = get_config("bert-large")
    if not args.full_width:
        cfg = smoke_variant(cfg, d_model=args.d_model, n_blocks=2)
        if args.full_depth:
            cfg = dataclasses.replace(cfg, n_layers=24)
    return dataclasses.replace(cfg, max_position=512)


def run(argv=None):
    """Train; returns (cfg, final TrainState, history), one history record
    per logged step (every step while a phase has at most 19): phase, step
    (1-based within the phase), loss, mlm_loss, nsp_loss, mlm_acc,
    grad_norm, lr, loss_scale, skipped (0 or 1), the step's wall time in
    ms (host clock, ending when the loss is read back) and the loop's
    counters (steps_per_s, tokens_per_s, consecutive_skips, total_skips,
    slow_steps, retries).  With ``--dp`` every rank returns its own (the
    same numbers)."""
    args = parse_args(argv)
    mesh = dp_mesh(args) if args.dp else None
    try:
        return _train(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _train(args, mesh):
    cfg = model_config(args)
    policy = make_policy(args.precision)
    device = args.device if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    workdir = args.workdir or (tempfile.mkdtemp(prefix="repro_bert_")
                               if lead else None)
    workdir = Path(workdir if mesh is None else mesh.broadcast_object(workdir))
    params = api.init_params(cfg, seed=args.seed, dtype=torch.float32,
                             device=device)
    logger.info("BERT variant: %d layers, d_model %d, %.1fM params, %s on %s%s",
                cfg.n_layers, cfg.d_model, tree_count(params) / 1e6,
                args.precision, device,
                f"; data parallel, {args.strategy}, {mesh.describe()}"
                if mesh else "")
    state, history, loop_launches, drained = None, [], {}, {}
    for phase in bert_phases(args.steps, scale_batch=args.batch / 4096):
        logger.info("=== %s: seq %d, %d preds, batch %d, %d steps ===",
                    phase.name, phase.seq_len, phase.n_predictions,
                    phase.global_batch, phase.steps)
        if phase.steps <= 0:
            continue
        shard_dir = workdir / phase.name
        if lead:
            prepare_bert_data(str(shard_dir), seq_len=phase.seq_len,
                              n_predictions=phase.n_predictions, n_docs=120,
                              vocab_size=cfg.vocab_size, n_shards=4,
                              seed=args.seed)
        if mesh is not None:
            mesh.barrier()
        loader = ShardedLoader(str(shard_dir), worker=0, n_workers=1,
                               batch=phase.global_batch, seed=args.seed)
        tcfg = TrainConfig(precision=args.precision, accum_steps=args.accum,
                           collective_strategy=args.strategy,
                           grad_compression=args.grad_compression,
                           overlap_exchange=args.overlap,
                           optimizer="lamb",
                           learning_rate=phase.learning_rate * 20,
                           total_steps=phase.steps,
                           warmup_steps=max(2, phase.steps // 10),
                           **({} if args.bucket_bytes is None else
                              {"bucket_bytes": args.bucket_bytes}))
        if state is None:
            state = init_train_state(
                params, policy, tcfg, world=1 if mesh is None else mesh.world,
                rank=0 if mesh is None else mesh.rank)
            del params
        timing_calib = None
        if args.timing_breakdown:
            timing_calib = timing_calibration(
                cfg, tcfg, mesh, policy, state,
                next(ShardedLoader(str(shard_dir), worker=0, n_workers=1,
                                   batch=phase.global_batch,
                                   seed=args.seed)), device)
            if lead:
                logger.info("%s timing calibration: compute %.1f ms | "
                            "serial step %.1f ms", phase.name,
                            timing_calib["compute_s"] * 1e3,
                            timing_calib["serial_step_s"] * 1e3)
        if mesh is not None:
            train_step = make_train_step_dp(cfg, tcfg, mesh)
        else:
            def train_step(state, batch, tcfg=tcfg):
                return train_step_fn(state, batch, cfg=cfg, tcfg=tcfg,
                                     policy=policy)

        def step_fn(state, batch, train_step=train_step):
            batch = api.to_device(batch, device)
            t0 = time.perf_counter()
            state, m = train_step(state, batch)
            m["loss"] = float(m["loss"])
            m["ms"] = (time.perf_counter() - t0) * 1e3
            # the compressed exchange's local work (CUDA events on the card)
            for k, v in getattr(train_step, "compress_s", {}).items():
                m[f"{k}_s"] = v
            if getattr(train_step, "bucket_order", None) is not None:
                drained["order"] = (train_step.bucket_order,
                                    train_step.n_buckets)
            return state, m

        def metrics_hook(m, phase=phase):
            history.append({"phase": phase.name, **m})
            if not lead:
                return
            nan = float("nan")   # a forged non-finite step has no metrics
            logger.info("%s step %d: loss %.4f (mlm %.4f, nsp %.4f), grad "
                        "norm %.3f, lr %.3g, %.1f ms%s", phase.name,
                        m["step"], m["loss"], m.get("mlm_loss", nan),
                        m.get("nsp_loss", nan), m.get("grad_norm", nan),
                        m.get("lr", nan), m.get("ms", nan),
                        ("" if "quantise_s" not in m else
                         f"; quantise_s {m['quantise_s']:.5f}, dequantise_s "
                         f"{m['dequantise_s']:.5f}")
                        + ("" if "compute_s" not in m else
                           f"; compute_s {m['compute_s']:.4f}, exchange_s "
                           f"{m['exchange_s']:.4f}, overlap_frac "
                           + (f"{m['overlap_frac']:.3f}"
                              if "overlap_frac" in m else "none (the serial "
                              "twin shows no exchange time)")))
            if args.loss_log:
                with open(args.loss_log, "a") as f:
                    f.write(json.dumps({"phase": phase.name,
                                        "step": m["step"],
                                        "loss": m["loss"]}) + "\n")

        # the loops' own launches, the calibration twins' left out
        before = ops.launch_counts()
        # one checkpoint directory a phase: step numbering restarts in each
        state, _ = train_loop(
            step_fn, state, iter(loader), total_steps=phase.steps,
            log_every=max(1, phase.steps // 10),
            ckpt_dir=str(workdir / "ckpt" / phase.name),
            ckpt_every=args.ckpt_every or max(10, phase.steps // 2),
            resume=args.resume, metrics_hook=metrics_hook,
            config_fingerprint=f"bert:{phase.name}:{args.precision}",
            seed=args.seed,
            tokens_per_step=phase.global_batch * phase.seq_len, mesh=mesh,
            timing_calib=timing_calib)
        for k, n in ops.launch_counts().items():
            loop_launches[k] = loop_launches.get(k, 0) + n - before.get(k, 0)
    logger.info("two-phase pretraining complete (data and checkpoints in "
                "%s); training-loop kernel launches %s", workdir,
                json.dumps(loop_launches))
    if mesh is not None:
        if state.err is not None:
            logger.info("dp rank %d of %d: residual digest %s", mesh.rank,
                        mesh.world, state.residual_digest())
        if "order" in drained:
            logger.info("dp rank %d of %d: the last step's drain started "
                        "buckets %s of %d during the backward", mesh.rank,
                        mesh.world, json.dumps(drained["order"][0]),
                        drained["order"][1])
        logger.info("dp rank %d of %d: state digest %s, losses %s",
                    mesh.rank, mesh.world, state.digest(),
                    json.dumps([r["loss"].hex() for r in history]))
    return cfg, state, history


def main(argv=None):
    rank = f" rank {os.environ['RANK']}" if "RANK" in os.environ else ""
    logging.basicConfig(level=logging.INFO,
                        format=f"[%(levelname)s %(name)s{rank}] %(message)s")
    run(argv)


if __name__ == "__main__":
    main()
