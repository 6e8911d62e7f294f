"""Where the training time goes on the card: a torch.profiler breakdown of
full training steps of BERT.

  PYTHONPATH=src python -m repro_torch.launch.profile_train \
      [--full-width] [--steps 3] [--precision bf16]

Builds bert-large (as published with ``--full-width``, else the 2-layer
smoke variant) with seeded random weights and LAMB state, and times
``train_step_fn`` at the geometry of ``chip_smoke.py``'s training phase:
accumulation 2, phase 1 at a global batch of 128 x 128 tokens, phase 2 at
64 x 512 (synthetic batches from ``api.make_synth_batch``).  For each
phase it prints one JSON line, as ``profile_serve.py`` does: wall time per
step (host clock around an unprofiled loop that ends in a synchronize),
device busy time (the sum of the CUDA kernels' durations in the trace of a
second, profiled loop), the idle share (1 - busy / wall), the device time
by kind of kernel, the kernels that took the most device time and the
device time of each autograd function's backward.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.configs.base import InputShape
from repro_torch.core.amp import make_policy
from repro_torch.launch.profile_serve import _phase
from repro_torch.models import api
from repro_torch.train.train_step import init_train_state, train_step_fn

SEED = 0
PHASES = (("phase1", 128, 128), ("phase2", 512, 64))   # name, seq, batch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--precision", default="bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the card: no CUDA device")
    cfg = get_config("bert-large")
    if not args.full_width:
        cfg = smoke_variant(cfg, d_model=128, n_blocks=2)
    pol = make_policy(args.precision)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "arch": cfg.arch_id, "full_width": args.full_width,
                      "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "precision": args.precision, "accum_steps": 2}),
          flush=True)
    state = None
    for name, seq, batch in PHASES:
        # a long warmup keeps the learning rate off zero through the run
        tcfg = TrainConfig(precision=args.precision, accum_steps=2,
                           learning_rate=2e-3, warmup_steps=1000,
                           total_steps=10000)
        if state is None:
            state = init_train_state(
                api.init_params(cfg, seed=SEED, device="cuda"), pol, tcfg)
        data = api.to_device(api.make_synth_batch(
            SEED, cfg, InputShape(name, seq, batch, "train")), "cuda")

        def step():
            train_step_fn(state, data, cfg=cfg, tcfg=tcfg, policy=pol)

        step()   # warm-up: cuBLAS plans, allocator
        _phase(f"train_step_{name}", step, args.steps, extra=_backward_fns)


def _backward_fns(prof, iters):
    """Device time of each autograd function's backward (its kernels
    included), per step: where the backward pass spends the card."""
    rows = []
    for e in prof.key_averages():
        head, _, fn = e.key.partition("autograd::engine::evaluate_function: ")
        if head or not fn:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        rows.append({"fn": fn, "ms_per_iter": us / 1e3 / iters,
                     "calls_per_iter": e.count / iters})
    rows.sort(key=lambda r: -r["ms_per_iter"])
    return {"backward_by_fn": rows[:12]}


if __name__ == "__main__":
    main()
