"""Two-phase BERT pretraining, the paper's experiment (counterpart of
``examples/pretrain_bert.py``).

  PYTHONPATH=src python -m repro_torch.launch.pretrain_bert \
      [--steps 120] [--d-model 128] [--full-depth] [--full-width] \
      [--batch 16] [--accum 4] [--precision bf16|f32|f16] \
      [--device cuda|cpu] [--workdir DIR] [--seed 0] [--resume] \
      [--loss-log FILE]

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
``<workdir>/ckpt/<phase>`` every max(10, steps // 2) steps and at the end
of the phase (the newest 3 kept), a log line every max(1, steps // 10)
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
the loader's shuffles.  The reference example's data-parallel and
collective flags come with a later slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import TrainConfig
from repro_torch.core.amp import make_policy
from repro_torch.data.pipeline import ShardedLoader, prepare_bert_data
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.train.phases import bert_phases
from repro_torch.train.train_step import init_train_state, train_step_fn
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
    return ap.parse_args(argv)


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
    slow_steps, retries)."""
    args = parse_args(argv)
    cfg = model_config(args)
    policy = make_policy(args.precision)
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="repro_bert_"))
    params = api.init_params(cfg, seed=args.seed, dtype=torch.float32,
                             device=args.device)
    logger.info("BERT variant: %d layers, d_model %d, %.1fM params, %s on %s",
                cfg.n_layers, cfg.d_model, tree_count(params) / 1e6,
                args.precision, args.device)
    state, history = None, []
    for phase in bert_phases(args.steps, scale_batch=args.batch / 4096):
        logger.info("=== %s: seq %d, %d preds, batch %d, %d steps ===",
                    phase.name, phase.seq_len, phase.n_predictions,
                    phase.global_batch, phase.steps)
        if phase.steps <= 0:
            continue
        shard_dir = workdir / phase.name
        prepare_bert_data(str(shard_dir), seq_len=phase.seq_len,
                          n_predictions=phase.n_predictions, n_docs=120,
                          vocab_size=cfg.vocab_size, n_shards=4,
                          seed=args.seed)
        loader = ShardedLoader(str(shard_dir), worker=0, n_workers=1,
                               batch=phase.global_batch, seed=args.seed)
        tcfg = TrainConfig(precision=args.precision, accum_steps=args.accum,
                           optimizer="lamb",
                           learning_rate=phase.learning_rate * 20,
                           total_steps=phase.steps,
                           warmup_steps=max(2, phase.steps // 10))
        if state is None:
            state = init_train_state(params, policy, tcfg)
            del params

        def step_fn(state, batch, tcfg=tcfg):
            batch = api.to_device(batch, args.device)
            t0 = time.perf_counter()
            state, m = train_step_fn(state, batch, cfg=cfg, tcfg=tcfg,
                                     policy=policy)
            m["loss"] = float(m["loss"])
            m["ms"] = (time.perf_counter() - t0) * 1e3
            return state, m

        def metrics_hook(m, phase=phase):
            history.append({"phase": phase.name, **m})
            nan = float("nan")   # a forged non-finite step has no metrics
            logger.info("%s step %d: loss %.4f (mlm %.4f, nsp %.4f), grad "
                        "norm %.3f, lr %.3g, %.1f ms", phase.name, m["step"],
                        m["loss"], m.get("mlm_loss", nan),
                        m.get("nsp_loss", nan), m.get("grad_norm", nan),
                        m.get("lr", nan), m.get("ms", nan))
            if args.loss_log:
                with open(args.loss_log, "a") as f:
                    f.write(json.dumps({"phase": phase.name,
                                        "step": m["step"],
                                        "loss": m["loss"]}) + "\n")

        # one checkpoint directory a phase: step numbering restarts in each
        state, _ = train_loop(
            step_fn, state, iter(loader), total_steps=phase.steps,
            log_every=max(1, phase.steps // 10),
            ckpt_dir=str(workdir / "ckpt" / phase.name),
            ckpt_every=max(10, phase.steps // 2), resume=args.resume,
            metrics_hook=metrics_hook,
            config_fingerprint=f"bert:{phase.name}:{args.precision}",
            seed=args.seed,
            tokens_per_step=phase.global_batch * phase.seq_len)
    logger.info("two-phase pretraining complete (data and checkpoints in "
                "%s); kernel launches %s", workdir,
                json.dumps(ops.launch_counts()))
    return cfg, state, history


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s %(name)s] %(message)s")
    run(argv)


if __name__ == "__main__":
    main()
