"""Where the training time goes on the card: a torch.profiler breakdown of
full training steps of BERT or of the decoder LM.

  PYTHONPATH=src python -m repro_torch.launch.profile_train \
      [--full-width] [--steps 3] [--precision bf16] \
      [--arch bert-large|deepseek-7b]

Builds bert-large (as published with ``--full-width``, else the 2-layer
smoke variant) with seeded random weights and LAMB state, and times
``train_step_fn`` at the geometry of ``chip_smoke.py``'s training phase:
accumulation 2, phase 1 at a global batch of 128 x 128 tokens, phase 2 at
64 x 512 (synthetic batches from ``api.make_synth_batch``).  For each
phase it prints one JSON line, as ``profile_serve.py`` does: wall time per
step (host clock around an unprofiled loop that ends in a synchronize),
device busy time (the time during which at least one CUDA kernel of the
trace of a second, profiled loop ran: the column sum of the LayerNorm
backward is a programmatic dependent launch whose span overlaps the
kernel it waits for, so summed durations would count that twice), the idle share (1 - busy / wall), the device time
by kind of kernel, the kernels that took the most device time, the device
time of each autograd function's backward, and how the LayerNorm
backward's time splits: under non-reentrant checkpoint the first
LayerNorm backward of a block recomputes the block's forward, so
``_LayerNormBackward`` holds that recompute, and the span
``kernels.ops.LAYERNORM_BWD_SPAN`` inside it holds the LayerNorm backward
alone.  ``--arch`` with a decoder profiles the decoder trainer's step
instead, at its training path on one card (``LM_PATHS``, the table
``chip_smoke.py``'s training phases read too): full width (with
``--full-width``; the CLI's model of ``launch/train.py --full --layers
N``) at N layers, one phase of B x S tokens with accumulation 2:
deepseek-7b at 4 layers, 8 x 1024; gemma2-27b at its first (local) layer,
2 x 8192; qwen1.5-32b at 1 layer and deepseek-coder-33b at 2, 8 x 1024;
rwkv6-1.6b whole (24 layers), 8 x 1024.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.configs.base import InputShape
from repro_torch.core.amp import make_policy
from repro_torch.kernels import ops
from repro_torch.launch.profile_serve import _phase
from repro_torch.launch.train import model_config as train_model
from repro_torch.launch.train import parse_args as train_args
from repro_torch.models import api
from repro_torch.train.train_step import init_train_state, train_step_fn

SEED = 0
PHASES = (("phase1", 128, 128), ("phase2", 512, 64))   # name, seq, batch
# a decoder's training path on one card: (depth at full width, global
# batch, seq, accumulation steps)
LM_PATHS = {"deepseek-7b": (4, 8, 1024, 2), "gemma2-27b": (1, 2, 8192, 2),
            "qwen1.5-32b": (1, 8, 1024, 2),
            "deepseek-coder-33b": (2, 8, 1024, 2),
            "rwkv6-1.6b": (24, 8, 1024, 2)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--arch", default="bert-large",
                    choices=("bert-large", *LM_PATHS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the card: no CUDA device")
    cfg = get_config(args.arch)
    accum = 2
    if cfg.is_encoder_only:
        phases = PHASES
        if not args.full_width:
            cfg = smoke_variant(cfg, d_model=128, n_blocks=2)
    else:
        layers, batch, seq, accum = LM_PATHS[args.arch]
        phases = (("lm", seq, batch),)
        cfg = train_model(train_args(
            ["--arch", args.arch, "--full", "--layers", str(layers)]
            if args.full_width else ["--arch", args.arch]))
    pol = make_policy(args.precision)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "arch": cfg.arch_id, "full_width": args.full_width,
                      "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "precision": args.precision, "accum_steps": accum}),
          flush=True)
    state = None
    for name, seq, batch in phases:
        # a long warmup keeps the learning rate off zero through the run
        tcfg = TrainConfig(precision=args.precision, accum_steps=accum,
                           learning_rate=2e-3, warmup_steps=1000,
                           total_steps=10000)
        if state is None:
            state = init_train_state(
                api.init_params(cfg, seed=SEED, device="cuda"), pol, tcfg,
                cfg=cfg)
        data = api.to_device(api.make_synth_batch(
            SEED, cfg, InputShape(name, seq, batch, "train")), "cuda")

        def step():
            train_step_fn(state, data, cfg=cfg, tcfg=tcfg, policy=pol)

        step()   # warm-up: cuBLAS plans, allocator
        _phase(f"train_step_{name}", step, args.steps, extra=_backward_fns)


def _device_us(e):
    us = getattr(e, "device_time_total", None)
    return e.cuda_time_total if us is None else us


def _backward_fns(prof, iters):
    """Device time of each autograd function's backward (its kernels
    included), per step: where the backward pass spends the card; and the
    LayerNorm backward's split into its own work (the span) and the rest
    (the checkpointed blocks' recompute)."""
    rows, span = [], {"ms_per_iter": 0.0, "calls_per_iter": 0.0}
    for e in prof.key_averages():
        if e.key == ops.LAYERNORM_BWD_SPAN:
            span = {"ms_per_iter": _device_us(e) / 1e3 / iters,
                    "calls_per_iter": e.count / iters}
        head, _, fn = e.key.partition("autograd::engine::evaluate_function: ")
        if head or not fn:
            continue
        rows.append({"fn": fn, "ms_per_iter": _device_us(e) / 1e3 / iters,
                     "calls_per_iter": e.count / iters})
    rows.sort(key=lambda r: -r["ms_per_iter"])
    ln = next((r["ms_per_iter"] for r in rows
               if r["fn"] == "_LayerNormBackward"), 0.0)
    return {"backward_by_fn": rows[:12],
            "layernorm_backward_split": {
                "fn_ms_per_iter": ln, "span": span,
                "rest_ms_per_iter": ln - span["ms_per_iter"]}}


if __name__ == "__main__":
    main()
