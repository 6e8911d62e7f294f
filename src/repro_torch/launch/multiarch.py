"""Train every assigned architecture for a few steps through the public API
(counterpart of ``examples/multiarch.py``).

  PYTHONPATH=src python -m repro_torch.launch.multiarch \
      [--archs all|a,b,c] [--steps 8] [--device cuda|cpu]

Every family of the reference's ``ASSIGNED`` list -- dense, MoE, SSM
(rwkv6-1.6b), hybrid (jamba-1.5-large-398b), audio (the encoder-decoder
whisper-small) and vision-language (qwen2-vl-7b) -- at its
``smoke_variant``, through the same training step and optimization stack:
bf16, two micro-batches of accumulation, LAMB at lr 1e-3 with 2 warmup
steps over ``--steps``, MoE layers on ``moe_impl="dense"``, and one
synthetic batch of 8 x 64 tokens (``api.make_synth_batch``; an
encoder-decoder's frames and a vision model's embeddings beside them)
reused every step, as the reference's example does.  Each model logs its
first and last loss, its seconds, "improving" or "flat", and the port's
kernels it launched with their counts.  On the card (the default) the
kernels run wherever the trainer launches them: the LAMB moments of every
leaf group, the flash pair of whisper's encoder, LayerNorm and bias-GELU
where a model has them, wkv6 in rwkv's layers; ``--device cpu`` runs
their plain versions.  Weights are random, drawn from seed 0, the batch
from seed 1.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.configs import ASSIGNED, TrainConfig, get_config, smoke_variant
from repro_torch.configs.base import InputShape
from repro_torch.core.amp import make_policy
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.train.train_step import init_train_state, train_step_fn

logger = logging.getLogger("repro_torch.multiarch")
SHAPE = InputShape("demo", 64, 8, "train")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default="all",
                    help="'all' (the reference's ASSIGNED list) or a comma "
                    "list of architectures")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.archs = ASSIGNED if args.archs == "all" else args.archs.split(",")
    for arch in args.archs:
        if arch not in ASSIGNED:
            raise SystemExit(f"--archs: {arch!r} is not one of {ASSIGNED}")
    return args


def train_arch(arch: str, steps: int, device) -> dict:
    """``steps`` training steps of ``arch``'s smoke variant on one batch.
    Returns {"arch", "family", "losses" (floats), "s", "launches" (the
    port's kernels launched in the loop, by name)}."""
    cfg = smoke_variant(get_config(arch))
    tcfg = TrainConfig(precision="bf16", accum_steps=2, optimizer="lamb",
                       learning_rate=1e-3, total_steps=steps,
                       warmup_steps=2, moe_impl="dense")
    pol = make_policy(tcfg.precision)
    state = init_train_state(api.init_params(cfg, seed=0, device=device),
                             pol, tcfg, cfg=cfg)
    batch = api.to_device(api.make_synth_batch(1, cfg, SHAPE), device)
    before = ops.launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = train_step_fn(state, batch, cfg=cfg, tcfg=tcfg,
                                 policy=pol)
        losses.append(float(m["loss"]))
    secs = time.perf_counter() - t0
    launches = {k: n - before.get(k, 0) for k, n in
                ops.launch_counts().items() if n - before.get(k, 0)}
    logger.info("%-22s [%-7s] loss %.3f -> %.3f  (%.1fs, %s); kernel "
                "launches %s", arch, cfg.family, losses[0], losses[-1],
                secs, "improving" if losses[-1] < losses[0] else "flat",
                launches)
    return {"arch": arch, "family": cfg.family, "losses": losses, "s": secs,
            "launches": launches}


def run(argv=None) -> list:
    """Train each of ``--archs``; returns their ``train_arch`` records.
    Raises ``RuntimeError`` if any loss is not finite."""
    args = parse_args(argv)
    out = []
    for arch in args.archs:
        rec = train_arch(arch, args.steps, args.device)
        if not np.isfinite(rec["losses"]).all():
            raise RuntimeError(f"{arch}: non-finite losses {rec['losses']}")
        out.append(rec)
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
