"""Decoder-LM training launcher (counterpart of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
      --steps 50 --batch 8 --seq 256 [--smoke | --full [--layers N]] \
      [--precision bf16|f32|f16] [--optimizer lamb|adamw] [--accum 4] \
      [--device cuda|cpu] [--dp --strategy psum|ring|hierarchical|bucketed] \
      [--grad-compression none|fp16|int8] \
      [--overlap --bucket-bytes N --timing-breakdown] \
      [--ckpt-dir DIR --ckpt-every 500 --resume] [--loss-log FILE] \
      [--log-every 10] [--seed 0]

  PYTHONPATH=src torchrun --standalone --nproc-per-node N \
      -m repro_torch.launch.train --dp [--strategy ring] ...

The flags are the reference's, with the same defaults and refusals
(``--grad-compression``, ``--overlap`` and ``--timing-breakdown`` need
``--dp``; an encoder-only arch is BERT, whose trainer is
``launch/pretrain_bert.py``), and the same ``TrainConfig`` (warmup
max(2, steps // 10), ``total_steps`` = ``--steps``), batches (the
resumable Zipfian ``LMStream`` of ``data/pipeline.py``, one global batch
of ``--batch`` x (``--seq`` + 1) tokens a step, the reference's token
arrays bit for bit) and checkpoint fingerprint.  Each step runs the AMP
policy, ``--accum`` micro-batches of fp32 gradient accumulation and LAMB
or AdamW with fp32 master weights, under the supervised loop
(``train/trainer.py`` ``train_loop``): checkpoints in ``--ckpt-dir``
every ``--ckpt-every`` steps and at the end, ``--resume`` from the newest
valid one with the stream's cursor (a run crashed by
``REPRO_FAULTS=crash_at=N``, exit 43, continues to the losses of an
uninterrupted one, bit for bit: give both the same ``--steps``), and
``--loss-log`` appends ``{"step", "loss"}`` a logged step.

``--arch`` takes every decoder the port runs: deepseek-7b, the dense
variants gemma2-27b (sliding-window local and global layers, softcaps,
post-norms, GeGLU, tied scaled embeddings), qwen1.5-32b (QKV biases) and
deepseek-coder-33b (56 query heads over 8 KV heads), and rwkv6-1.6b,
whose ``--seq`` must be at most 64 or a multiple of 64 (``min(64, S)``
divides S: wkv6's chunk).  ``--smoke`` (the default) takes
``smoke_variant`` of ``--arch``; ``--full`` takes it as published.
``--device cuda`` (the default) runs the kernels of ``csrc/`` (the flash
forward and backward at S^2 > 512^2, LayerNorm and its backward, the
wkv6 forward, LAMB's moment kernel); ``--device cpu`` their plain
versions.  Weights are random, drawn from ``--seed``.

One option the reference lacks, ``--layers N``: the model at depth N (full
width with ``--full``), a multiple of the block pattern's length or fewer
layers than it (gemma2's ``--layers 1`` is its first, local layer alone).
deepseek-7b at its 30 layers is ~6.9 B parameters, and a training state
on one card needs ~18 bytes a parameter (fp32 master, m, v and gradient
buffer, a bf16 compute copy), ~124 GB against the H100's 80 GB; the
reference reaches that depth only with its optimizer state sharded over a
mesh, which the port has not ported.  At ``--full --layers 4`` (1.65 B
parameters) a bf16 step fits one card.

``--dp`` is the reference's pure data parallelism
(``train_step.make_train_step_dp``) with the gradient exchange
``--strategy``: torchrun's ranks (NCCL and the card of ``LOCAL_RANK`` for
``--device cuda``, gloo for ``--device cpu``), or world 1 without
torchrun.  Every rank builds the same weights and reads the same global
batches, taking its rows of each; rank 0 writes the checkpoints, the loss
log and the step lines; every rank logs its state digest and loss bits
last.  ``--timing-breakdown`` times a compute twin and a serial twin at the
start (``pretrain_bert.timing_calibration``), and the loop then logs
``compute_s``, ``exchange_s`` and ``overlap_frac``.  ``--pure-dp`` (ZeRO-1:
the optimizer state sharded) is refused: it comes with the sharding
slice.  ``--moe-impl`` is accepted and changes nothing for a dense model.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import TrainConfig
from repro_torch.core import collectives as C
from repro_torch.core.amp import make_policy
from repro_torch.data.pipeline import lm_batches
from repro_torch.kernels import ops
from repro_torch.launch.pretrain_bert import dp_mesh, timing_calibration
from repro_torch.models import api
from repro_torch.train.train_step import (init_train_state,
                                          make_train_step_dp, train_step_fn)
from repro_torch.train.trainer import train_loop
from repro_torch.utils import tree_count

logger = logging.getLogger("repro_torch.train")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth of the model (full width with --full): a "
                    "multiple of the block pattern (gemma2-27b's 2: local, "
                    "global) or fewer layers than it; deepseek-7b, "
                    "qwen1.5-32b, deepseek-coder-33b and rwkv6-1.6b take "
                    "any depth; default: the config's")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--optimizer", default="lamb")
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
                    help="calibrate compute vs exchange time at startup "
                    "(times a no-exchange twin + a serial-schedule twin) "
                    "and report compute_s/exchange_s/overlap_frac in "
                    "--log-every output (requires --dp)")
    ap.add_argument("--pure-dp", action="store_true",
                    help="ZeRO-1 pure data parallelism (refused: the "
                    "sharding slice)")
    ap.add_argument("--moe-impl", default="a2a")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest valid checkpoint")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--loss-log", default=None,
                    help="append {'step','loss'} JSON lines here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
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
    if args.pure_dp:
        raise SystemExit("--pure-dp (ZeRO-1: the optimizer state sharded "
                         "over the ranks) comes with the sharding slice of "
                         "the port")
    return args


def model_config(args):
    """The model of ``--arch``, ``--smoke``/``--full`` and ``--layers``;
    ``SystemExit`` for one this trainer does not take."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if cfg.is_encoder_only:
        raise SystemExit("use launch/pretrain_bert.py for BERT")
    if args.layers is not None:
        pattern = cfg.block_pattern
        if args.layers <= 0 or (args.layers > len(pattern)
                                and args.layers % len(pattern)):
            raise SystemExit(f"--layers {args.layers} must be fewer than "
                             f"the block pattern's {len(pattern)} layers or "
                             "a positive multiple of them")
        cfg = dataclasses.replace(
            cfg, n_layers=args.layers,
            block_pattern=tuple(pattern[:args.layers]))
    try:
        api.check_trainable(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"{cfg.arch_id}: {e}") from None
    if any(mixer == "rwkv" for mixer, _ in cfg.layer_kinds()) and \
            args.seq % min(64, args.seq):
        raise SystemExit(f"{cfg.arch_id}: --seq {args.seq} must be a "
                         "multiple of wkv6's 64-token chunk (or at most 64: "
                         "min(64, S) divides S)")
    return cfg


def run(argv=None):
    """Train; returns (cfg, final TrainState, history): one record a
    logged step (``train_loop``'s metrics: step, loss, lm_loss, grad_norm,
    lr, loss_scale, skipped, the step's wall ``ms`` (host clock, ending when
    the loss is read back) and the loop's counters).  With ``--dp`` every
    rank returns its own (the same numbers)."""
    args = parse_args(argv)
    cfg = model_config(args)
    mesh = dp_mesh(args) if args.dp else None
    try:
        return _train(args, cfg, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _train(args, cfg, mesh):
    device = args.device if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    tcfg = TrainConfig(precision=args.precision, accum_steps=args.accum,
                       collective_strategy=args.strategy,
                       grad_compression=args.grad_compression,
                       overlap_exchange=args.overlap,
                       optimizer=args.optimizer, total_steps=args.steps,
                       warmup_steps=max(2, args.steps // 10),
                       moe_impl=args.moe_impl, seed=args.seed,
                       **({} if args.bucket_bytes is None else
                          {"bucket_bytes": args.bucket_bytes}))
    tcfg.check_supported()
    policy = make_policy(tcfg.precision)
    params = api.init_params(cfg, seed=args.seed, dtype=torch.float32,
                             device=device)
    logger.info("arch %s: %.2fM params (smoke=%s), %d layers, d_model %d, "
                "%s on %s, %s%s", cfg.arch_id, tree_count(params) / 1e6,
                args.smoke, cfg.n_layers, cfg.d_model, args.precision,
                device, args.optimizer,
                f"; data parallel, {args.strategy}, {mesh.describe()}"
                if mesh else "")
    state = init_train_state(params, policy, tcfg, cfg=cfg,
                             world=1 if mesh is None else mesh.world,
                             rank=0 if mesh is None else mesh.rank)
    del params

    if mesh is not None:
        train_step = make_train_step_dp(cfg, tcfg, mesh)
    else:
        def train_step(state, batch):
            return train_step_fn(state, batch, cfg=cfg, tcfg=tcfg,
                                 policy=policy)

    def stream():
        return lm_batches(args.seed, cfg.vocab_size, args.batch, args.seq)

    fingerprint = (f"{cfg.arch_id}:p={args.precision}:b={args.batch}x"
                   f"{args.seq}:opt={args.optimizer}:accum={args.accum}:"
                   f"seed={args.seed}:comp={args.grad_compression}:"
                   f"ov={int(tcfg.overlap_exchange)}:bb={tcfg.bucket_bytes}")

    timing_calib = None
    if args.timing_breakdown:
        timing_calib = timing_calibration(
            cfg, tcfg, mesh, policy, state, next(stream()), device)
        if lead:
            logger.info("timing calibration: compute %.1f ms | serial step "
                        "%.1f ms", timing_calib["compute_s"] * 1e3,
                        timing_calib["serial_step_s"] * 1e3)

    def step_fn(state, batch):
        batch = api.to_device(batch, device)
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        m["loss"] = float(m["loss"])
        m["ms"] = (time.perf_counter() - t0) * 1e3
        return state, m

    def metrics_hook(m):
        if not lead:
            return
        logger.info("step %d: loss %.4f, grad norm %.3f, lr %.3g, loss "
                    "scale %g, %.1f ms", m["step"], m["loss"],
                    m.get("grad_norm", float("nan")),
                    m.get("lr", float("nan")),
                    m.get("loss_scale", float("nan")),
                    m.get("ms", float("nan")))
        if args.loss_log:
            with open(args.loss_log, "a") as f:
                f.write(json.dumps({"step": m["step"], "loss": m["loss"]})
                        + "\n")

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = ops.launch_counts()
    state, history = train_loop(
        step_fn, state, stream(), total_steps=args.steps,
        log_every=args.log_every, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume,
        metrics_hook=metrics_hook, config_fingerprint=fingerprint,
        seed=args.seed, tokens_per_step=args.batch * args.seq,
        timing_calib=timing_calib, mesh=mesh)
    launches = {k: n - before.get(k, 0) for k, n in
                ops.launch_counts().items() if n - before.get(k, 0)}
    peak = (f", peak device memory "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
            if torch.device(device).type == "cuda" else "")
    if history:
        logger.info("final loss: %.4f; training-loop kernel launches %s%s",
                    history[-1]["loss"], json.dumps(launches), peak)
    else:
        logger.info("nothing to do: checkpoint already at %d steps",
                    args.steps)
    if mesh is not None:
        if state.err is not None:
            logger.info("dp rank %d of %d: residual digest %s", mesh.rank,
                        mesh.world, state.residual_digest())
        logger.info("dp rank %d of %d: state digest %s, losses %s",
                    mesh.rank, mesh.world, state.digest(),
                    json.dumps([r["loss"].hex() for r in history]))
    return cfg, state, history


def main(argv=None):
    rank = f" rank {os.environ['RANK']}" if "RANK" in os.environ else ""
    logging.basicConfig(level=logging.INFO,
                        format=f"[%(levelname)s %(name)s{rank}] %(message)s")
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
