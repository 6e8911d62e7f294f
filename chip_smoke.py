#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

  python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of ``src/repro_torch/csrc/`` (one nvcc per
   source, all at once).
3. Kernel phase: holds each kernel against its plain PyTorch version on the
   card -- flash forward at the prefill shape (1, 32, 1024, 128) bf16 causal
   plus small causal x window x softcap cases in f32, bf16 and f16 (out and
   lse, each within the tolerance below and the relative L2 bound of its
   dtype):
   GQA at every head dim, S 256, 200, 130 (across a 128-row q tile) and 17
   (under one), Dh 32, 64 and 128, and the model's (B, S, H, Dh) layout read
   through transposed views with ``out=`` into one; paged
   decode with page_size 16 over f32, bf16 and int8 pages, H/KV 1, 2, 4,
   7 and 8, at B = 5 and B = 8 with one empty slot and one slot whose table
   points at the trash page, at tables the split kernel splits (one slot
   of 600-1040 tokens, two of 2000-4800 in 300-page tables), at short
   contexts (B = 4 slots of 16-64 tokens in the serve tables) and at the
   serve phase's geometry (B = 4 live slots of 600-1040 tokens, disjoint
   tables); the split tables and the serve geometry must give the same
   bits when launched twice, all but the small cases are timed, and the
   split plan and the split kernel's ptxas registers are logged.
   Tolerance: 3e-2 for bf16, 1e-2 for f16, 2e-4 for f32.  Times the path
   shapes (paged:
   the serve geometry) with CUDA events after warm-up, the L2 cache flushed
   before every launch, beside the plain version and (flash only)
   ``scaled_dot_product_attention`` as a yardstick the port never calls.
4. Serve phase: full-width, full-depth deepseek-7b in bf16 with seeded
   random weights, served by ``ContinuousScheduler`` with
   cache_mode "paged" and then "paged_int8": batch 4, prefill bucket 1024,
   max_len 1040, 8 requests of 600-1024 prompt tokens and 4-16 new tokens.
   Launch counts are zeroed just before each run and read just after; both
   kernels must have launched, every logit must be finite and every page
   must come back.  Then one request's prefill and first 4 decode steps run
   again through the kernels and through the plain versions
   (``impl="torch"``), in bf16 and in f32 (the same seeded weights).  Every
   kernel call of the kernel path is held against its plain version on that
   call's own inputs at the tolerance above (30 flash calls at the full
   (1, 32, 1024, 128) shape, 120 paged calls), and the logits of the two
   paths must agree within the bound stated for each dtype.  Then, on the
   same bf16 weights, the prefix cache and the cohort scheduler:
   (a) the prefix trace (``prefix_trace``: 12 requests, two 512-token
   heads, two exact repeats admitted beside their seeds; max_len 2064, the
   CLI's headroom rule) through ``ContinuousScheduler(prefix_cache=True)``
   in "paged" and "paged_int8" and unshared in "paged": hits, full hits,
   copy-on-write copies and saved prefill tokens all occur, fewer prefill
   tokens than unshared, every request produces tokens, finite logits,
   every page back, both kernels launched (paged decode on the split
   kernel); in "paged" each full hit's tokens equal its seed's in bits
   (logged in int8), and how many requests equal the unshared run's is
   logged.  (b) A 777-token prompt whole into slot 0 and as a 512-token
   prefill plus a suffix prefill at 512 into slot 1, then 4 decode steps,
   every flash and paged call held against its plain version: logits rel
   L2 within ``SUFFIX_REL_L2_BOUND``.  (c) ``copy_page`` on that pool: the
   kept rows in bits (bf16) or within one quantisation step with a scale
   no larger than the source's (int8), the rest zero.  (d) 8 requests of
   600-1024 tokens through ``CohortScheduler`` (batch 4, the flash forward
   at (4, 32, 1024, 128), every call held): 2 cohorts, each output its
   budget, useful tokens and wasted slots as counted on the host.
4b. Dense decoder variants phase, after the deepseek phase has freed its
   memory: full width, depth cut, bf16 weights seeded on the card.  (a)
   gemma2-27b at 8 layers (4 local/global blocks): the serve CLI's raw
   mode, 2 prompts of 8192 tokens (twice the 4096 window: the flash
   forward's window mask bites on the local layers, softcap 50 on all,
   and the local rings keep the last 4096 positions) and 16 greedy decode
   steps, every flash call held against its plain version; the same
   prefill and 16 steps through the kernels and the plain versions,
   logits within ``LOGIT_REL_L2_BOUND``; ``ContinuousScheduler`` in
   contiguous mode (batch 4, bucket 4096 = the window, max_len 4224, 8
   requests of 600-4096 tokens, 4-16 new): every request produces tokens,
   the flash forward launches once a layer a prefill; ``paged``,
   ``paged_int8`` and ``prefix_cache`` raise ``ValueError``.  (b)
   qwen1.5-32b and (c) deepseek-coder-33b at 4 layers (qwen's QKV biases
   drawn non-zero from a seed) served as deepseek-7b is in "paged" and
   "paged_int8" (``serve_run``: the coder's paged decode at 56 heads over
   8, group 7, on the split kernel) and held kernels vs plain
   (``path_parity``: the coder's 7:1 flash prefill among its calls).  (d)
   The same holds in f32 at 2 layers (gemma2: one 8192-token prompt and 4
   decode steps).  Then the two new shapes timed beside the plain version,
   the bound, a ``torch.sum`` of the same bytes and an empty kernel, each
   held first: the flash forward at (2, 32, 8192, 128) over 16 KV heads,
   window 4096, softcap 50 (also run without the window, which must move
   the output), and paged decode at group 7 (bf16 and int8 pages, the
   serve geometry, split kernel, the same bits on relaunch).  No single
   PyTorch call computes either (SDPA has no softcap).
5. Training kernel phase: the kernels of the BERT training path against
   their plain versions -- the flash backward (pre-pass, main pass and, in
   16 bits over more than one 128-key tile, the post-pass that adds the dQ
   partials in tile order, as ``flash_attention_bwd`` launches them) over
   causal x window x softcap in f32, bf16 and f16 with ragged lengths (S
   256, 200, 130; Dh 64, 128, 32), in the (B, H, S, Dh) and the model's
   (B, S, H, Dh) layouts, each of dq, dk, dv within the tolerance above
   and the relative L2 bound of its dtype; LayerNorm and bias-GELU,
   forward and backward, at the reference test shapes in f32, bf16 and
   f16; LAMB at n in {128, 1000, 65553} -- then at the path shapes: flash
   forward and backward bidirectional at (64, 16, 128, 64) and
   (32, 16, 512, 64) in bf16 (the forward timed beside SDPA's forward and
   the whole backward timed, one JSON entry each a shape, with the spread
   of each kernel; at phase 1, where the main pass writes dq itself, the
   partials route is also held and timed on the same inputs; SDPA's
   forward and backward timed beside them) and in f16 (held and timed
   beside SDPA in f16), LayerNorm at every path shape (``LN_FWD_PATH``:
   phase 1 and 2, the MLM head, the rwkv raw prefill and rwkv's calls of 4
   and 256 rows) and its backward at the training ones, each held in f32,
   bf16 and f16 (TOL and the per-call rel L2 bound) and timed in bf16 and
   f16, bias-GELU 8192 x 4096, its backward at 8192 and 16384 x 4096 (and
   the MLM head's 1280 and 2560 x 1024, held only), in bf16 and f16, LAMB
   over the largest leaf group; timed as above beside the plain version,
   the bound and, where one PyTorch call computes the same function, that
   call (flash backward: the backward of ``scaled_dot_product_attention``;
   LayerNorm: ``F.layer_norm``; its backward: ``native_layer_norm_backward``
   on the same saved statistics).  The LayerNorm kernels are also timed
   under both flushes beside an empty kernel and one PyTorch op that moves
   exactly their bytes (``copy_`` of x; ``torch.add(x, dy, out=)``), the
   backward's two launches apart from a profiler trace, and their ptxas
   registers are logged.  Determinism, bit for bit: the flash backward at
   both training shapes (bf16 and f16), each row backward and the
   LayerNorm forward at their path shapes launched twice on the same
   inputs give the same bits.
6. wkv6 kernel phase: the RWKV-6 recurrence against its plain version at
   the CPU tests' cases (s, chunk) in {(128, 32), (256, 64), (64, 64),
   (32, 64)} plus chunks of 6 and 60 rows (one chunk) and two chunks of
   60, f32 and bf16 inputs, inputs read through strides and one element
   off the 16-byte grid, and strong decay (logw = -50 in chunks of 16 and
   64, -100 in chunks of 64), each on both grids (1 and 2 blocks a head),
   within rtol = atol = 1e-4 and relative L2 1e-4; then the raw prefill's
   shapes (4, 1024, 32, 64) and (1, 1024, 32, 64) bf16, each held the same
   way and launched twice for the same bits, timed on the plan's grid and
   on the other (held there too) beside the plain version and the bound
   (no single PyTorch call computes it; the first port's operation count
   logged beside the sub-chunk form's), the kernel's ptxas registers
   logged.
7. RWKV serve phases, after the deepseek phases have freed their memory:
   full-width, full-depth rwkv6-1.6b in bf16 with seeded random weights.
   The serve CLI's raw mode (batch 4, 1024-token prompts, 16 new tokens):
   wkv6 must launch once per layer (24) and every LayerNorm must launch
   its kernel, every logit finite.  ``ContinuousScheduler`` (batch 4,
   bucket 256, 6 requests of 64-256 tokens and 4-16 new): finite logits,
   no wkv6 launch (masked slot prefills run the sequential scan, as in
   the reference), every request run to its budget.  Then the raw path's
   prefill and 4 decode steps through the kernels and through the plain
   versions, in bf16 and in f32: every wkv6 call within the f32 tolerance
   (its absolute part scaled by the call's output RMS, which runs to
   ~10^2 there) and 1e-4 relative L2, every LayerNorm call within the
   dtype's, and the logits within the deepseek bounds.
8. Training phase, after the serve phases have freed their memory:
   ``launch/pretrain_bert.py`` at full width and depth (bert-large, LAMB,
   accumulation 2, ``--batch 128``: 4 phase-1 steps of 128 x 128 tokens
   and 1 phase-2 step of 64 x 512), in bf16 and then in the paper's f16
   with the dynamic loss scale, launch counts zeroed before and read after
   each (every kernel of the path must have launched, the two row
   backwards included; the flash forward's and backward main pass's
   launches, counted by the wrapper by sequence length, must add up),
   every loss finite (in f16 a skipped step is allowed, not every step).
   Then one step from a fresh state on a phase-1 batch through the kernels
   and through the plain versions, in f32, bf16 and f16: loss, every
   gradient group and the master-weight update must agree within the
   bound stated for each dtype, both paths must take the same step (finite
   flag, skip, loss scale), and every kernel call of the kernel path is
   held against its plain version on that call's own inputs.  Last, one
   bf16 gradient step on a phase-2 batch (8 x 512: the dQ partials and
   post-pass) with every call of each backward kernel held the same way,
   and two more from the same state, whose gradients are compared bit for
   bit and logged with the ops PyTorch names non-deterministic in the step
   (a reading; the kernels' own bit-for-bit holds are those of step 5).
   Each training run writes the final checkpoint of each phase (4.03 GB
   at full width), which is checked for and removed.
9. Resume phase: the fault-tolerant runtime through the real CLI, three
   processes of ``python -m repro_torch.launch.pretrain_bert --full-width
   --batch 128 --accum 2 --steps 13`` in bf16 (12 phase-1 steps with
   checkpoints at 10 and 12, 1 phase-2 step, every loss logged): an
   uninterrupted run; a run with ``REPRO_FAULTS=crash_at=11``, which must
   exit 43 with phase 1's newest valid checkpoint at step 10; and a
   ``--resume`` run in its workdir, which must restore step 10, replay 11
   and 12 and run phase 2.  Every loss of the crashed and resumed runs
   must have the uninterrupted run's float32 bits (``float.hex``), and
   every training kernel must have launched in the runs that ended.  The
   checkpoint bytes, each save's and restore's seconds and the runs'
   seconds are logged with the card's name and power limit; each run's
   workdir is removed once checked.
10. Data-parallel phase, four parts.  (a) NCCL at world 1 through the real
   CLI: ``python -m torch.distributed.run --standalone --nproc-per-node 1
   -m repro_torch.launch.pretrain_bert --dp --strategy psum`` with step
   8's arguments in bf16; every logged loss must have the float32 bits of
   step 8's bf16 run (at world 1 the all-reduce copies and the division by
   1 is exact) and every training kernel must have launched.  (a') The
   same with ``--strategy bucketed --overlap``, at the same time as (a),
   held the same way, every bucket of its last step started during the
   backward.  (c) Beside them, the
   same CLI with ``--grad-compression int8 --overlap --timing-breakdown
   --ckpt-every 3 --layers 4`` (bert-large's width at 4 of its 24
   layers), three processes: uninterrupted and, at the same time, crashed by
   ``REPRO_FAULTS=crash_at=4`` (after phase 1's checkpoint 3, whose
   residual group -- 26 leaves of (1, ...) -- must be nonzero); and
   resumed from step 3.  Every loss of the faulted runs must have the
   uninterrupted run's float32 bits, every training kernel must launch in
   the runs that end, and the runs log the compute twin's and serial
   twin's step (each phase) and ``compute_s``, ``exchange_s`` and
   ``overlap_frac`` (each logged step); the checkpoint's bytes and the
   residual's are logged.  (b) and (d) Four gloo ranks sharing the card:
   ``python -m repro_torch.launch.dp_check --full-width --layers 4 --world
   4 --pods 2 --backend gloo --share-device --cases ...`` (bert-large's
   width at 4 of its layers, bf16, one phase-1 global batch of 128 x 128
   tokens with
   accumulation 2, one step under each case: psum, ring, hierarchical,
   bucketed, then fp16 over hierarchical, int8 over psum, bucketed with
   the overlapped drain and int8 over psum with it): every rank's
   replicated state the same bits under each case; each uncompressed
   case's masters within rtol 1e-5, atol 1e-6 of psum's; every loss
   within rtol 1e-5 of psum's; each compressed case's mean gradients
   within the reference test's tolerance of psum's (fp16 1e-3, int8
   5e-2, relative and of each bucket's largest), each rank's residual
   nonzero and its own; each overlapped case the bits of its serial case;
   every kernel of a phase-1 step launched on every rank.  Each case's
   exchange seconds on each rank (staged through host memory, a reading
   of that path and not of NCCL), ``exchange_bytes_per_step`` for its
   compression, the quantise and dequantise seconds within it, the
   step's seconds, each rank's peak device memory and each part's
   seconds are logged.
11. Decoder-LM phase, after the BERT phases have freed their memory.
   The causal flash forward and whole backward at the LM path's shape
   (4, 32, 1024, 128) (Dh 128) in bf16 and f16: held against the plain
   version (TOL, CALL_REL_L2_BOUND), each launched twice for the same
   bits, timed beside SDPA's causal forward and backward, the plain
   version and the bound; LAMB over the LM's largest leaf group (the
   102400 x 4096 embedding), held and timed; ``F.embedding``'s backward of
   the full-width and the smoke token table probed for run-to-run bits
   (logged).  Then ``python -m repro_torch.launch.train --arch deepseek-7b
   --full --layers 4 --batch 8 --seq 1024 --accum 2 --steps 4`` in bf16,
   in process, with ``--optimizer lamb`` and then ``adamw``, launch counts
   zeroed before and read after each: every loss finite and no step
   skipped; the flash forward 16 and its backward (pre-pass, main pass,
   post-pass) 8 times a step, all at S 1024; LAMB's kernel once a leaf
   group a step under LAMB and never under AdamW; no other kernel.  Peak
   device memory is logged.  Then one LAMB step from a fresh state on the
   stream's first batch through the kernels and the plain versions, in
   f32 and bf16: loss, every gradient group and every group's master
   update within LM_BOUND, the same step taken, and every flash and LAMB
   call of the kernel path held against its plain version on its own
   inputs.  While those two steps run (nothing in them is timed), the CLI
   runs on the card at the smoke size and S 1024 (the flash pair at Dh
   32), ``--optimizer adamw``, 7 steps: uninterrupted;
   ``REPRO_FAULTS=crash_at=5`` (exit 43, newest checkpoint 3), then
   ``--resume``; and ``--dp --strategy ring`` through torchrun at world 1
   on NCCL: every loss of the resumed and the data-parallel runs has the
   uninterrupted run's float32 bits, and every flash kernel launched in
   each run that ended.
12. Training the dense decoder variants, full width, depth cut
   (``LM_PATHS``): gemma2-27b's first (local) layer at 2 x 8192 tokens
   (twice its window), qwen1.5-32b's first layer and deepseek-coder-33b's
   first two at 8 x 1024, each in 2 micro-batches.  (a) ``launch/train.py
   --full --layers N`` of each, 4 steps of bf16 under LAMB, in process:
   every loss finite and no step skipped, the launches exactly
   ``train_launches`` (the flash forward twice and its backward once a
   layer a micro-batch, K and V expanded over the query group; LAMB once a
   leaf group a step; nothing else).  (b) One LAMB step kernels vs plain
   in bf16 on the path and in f32 at one layer (gemma2's at S 4224), every
   flash and LAMB call held against its plain version, within LM_BOUND.
   (c) Two gradient steps of the coder from one state in the same bits;
   the flash forward and backward at gemma2's (1, 32, 8192, 128) with
   window 4096 and softcap 50 and at the coder's (4, 56, 1024, 128)
   launched twice for the same bits.  (d) The same two shapes held against
   the plain versions and timed beside their bounds, the plain versions,
   SDPA's forward and backward (the coder's) and the expansion's copy and
   group sum; the JSON rows ``flash_fwd_gemma2``, ``flash_bwd_gemma2``,
   ``flash_fwd_coder`` and ``flash_bwd_coder`` take those models' launches
   in (a), qwen's go on the LM path's rows.
13. Training rwkv6-1.6b at full width and depth, 8 x 1024 tokens in 2
   micro-batches: (a) the CLI as in 12 (wkv6 twice a layer a
   micro-batch, the recompute's included, its backward the chunked
   form's VJP; LayerNorm and its backward; LAMB), (b) one LAMB step
   kernels vs plain in bf16 and in f32 at one layer (the plain bf16
   path's distance from plain f32 logged beside it), every wkv6,
   LayerNorm and LAMB call held (wkv6 within WKV_TOL), within LM_BOUND;
   (e) the wkv6 forward and the VJP timed at the training shape
   (4, 1024, 32, 64).
14. Prints one JSON line of kernel results, then, as the last line,
   ``{"ok": true, "device": {...}}``.

``--only kernels`` stops after the kernel phases (a quick check of a new
kernel), ``--only layernorm`` after the build and the two LayerNorm phases,
``--only wkv6`` after the build and the wkv6 phase, ``--only resume`` after
the build and the resume phase, ``--only dp`` after the build, step 8's
bf16 run (the losses (a) is held to) and the data-parallel phase, ``--only
lm`` after the build and the decoder-LM phase, ``--only serve`` after the
build and the deepseek serve phase (step 4), ``--only decoders`` after the
build and the dense decoder variants phase (step 4b), ``--only
variants_train`` and ``--only rwkv_train`` after the build and step 12 or
13 (exit 2, no result line in each case); without arguments everything
runs.

Any failure raises and exits non-zero; without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))
# each decoder's training path on one card, the table
# ``launch/profile_train.py`` profiles: (layers at full width, global
# batch, S, micro-batches)
from repro_torch.launch.profile_train import LM_PATHS  # noqa: E402
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense, no TF32
# f16 keeps 3 more mantissa bits than bf16 (2**-11 against 2**-8 relative)
TOL = {torch.bfloat16: 3e-2, torch.float16: 1e-2, torch.float32: 2e-4}
SEED = 0
DEVICE = "cuda"

# full-width serve geometry
BATCH, PREFILL_LEN, MAX_LEN, PAGE_SIZE = 4, 1024, 1040, 16
SERVE_KERNELS = ("flash_fwd", "paged_decode")
N_REQUESTS = 8
# kernel-path vs plain-path logits (relative L2 over prefill + 4 decode
# steps) of the full-depth model.  In f32 the two differ only by summation
# order inside attention; in bf16 also by where one-ulp rounding differences
# land, and those compound over 30 layers: 3.73e-2 (paged) and 3.81e-2
# (int8) on an H100, the same to the digit in every run, as the seeds fix
# the data.  The bf16 bound sits between those and the least wrong flash
# kernel of launch/mutation_check.py (softmax scale 2 % off: 6.9e-2).  The
# tight check of the bf16 kernels is path_parity's per-call check.
LOGIT_REL_L2_BOUND = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# per kernel call, the relative L2 error of each output against the plain
# version on the same inputs.  The elementwise tolerance (TOL) is absolute
# below |want| = 1, and training gradients are ~1e-5: this bound is what
# holds them.  f32: summation order only, largest on LayerNorm's row means,
# which sit near 0 (6.6e-5 on the H100); bf16: rounding to bf16 (2**-9
# relative) and P and dS rounded to bf16 inside the flash backward (2.7e-3);
# f16: the same roundings at 2**-12, so between the two.
CALL_REL_L2_BOUND = {torch.float32: 1e-3, torch.bfloat16: 1e-2,
                     torch.float16: 5e-3}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of a callable: CUDA events around each launch, the L2
    cache flushed before every one, then a spin of ~0.5 ms on the card so
    that the host has queued all of the callable's kernels before the first
    starts: the time is the card's, not the host's.  The flush is a 256 MB
    write (the default: it leaves the L2 full of dirty lines, whose
    write-back then competes with the callable's reads) or a 256 MB read
    (clean lines, as the weight reads of a decode step leave them)."""

    def __init__(self):
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                 device=DEVICE)

    def times(self, fn, iters: int = 20, flush: str = "write") -> list:
        """ms of each of ``iters`` launches after one warm-up launch, each
        after a ``flush`` ("write" or "read") of the L2."""
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(iters):
            if flush == "write":
                self.flush.zero_()
            else:
                self.flush.view(torch.int64).sum()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def ms(self, fn, iters: int = 20) -> float:
        return float(np.mean(self.times(fn, iters)))


def spread(times: list) -> str:
    return (f"min {min(times):.4f} / median {float(np.median(times)):.4f} / "
            f"max {max(times):.4f} over {len(times)}")


def median(times: list) -> float:
    return float(np.median(times))


def yardstick_times(timer, fn, same, lib=None) -> dict:
    """Medians (ms) of ``fn``, of ``same`` (one PyTorch op that moves
    exactly ``fn``'s bytes), of ``lib`` (one PyTorch call computing the
    same function, where there is one) and of an empty kernel, under the
    write and under the read flush; ``"times"`` holds ``fn``'s write-flush
    times."""
    tiny = torch.zeros(1, device=DEVICE)
    out = {}
    for flush in ("write", "read"):
        k = timer.times(fn, flush=flush)
        out[flush] = {"kernel": median(k),
                      "same bytes": median(timer.times(same, flush=flush)),
                      "empty": median(timer.times(lambda: tiny.add_(1),
                                                  flush=flush))}
        if lib is not None:
            out[flush]["library"] = median(timer.times(lib, flush=flush))
        if flush == "write":
            out["times"] = k
    return out


def yardstick_log(res: dict, same: str, lib: str = "") -> str:
    return "; ".join(
        f"{flush} flush median: kernel {r['kernel']:.4f}, {same} "
        f"{r['same bytes']:.4f}, " + (f"{lib} {r['library']:.4f}, " if lib
                                      else "") +
        f"empty kernel {r['empty']:.4f}"
        for flush, r in res.items() if flush != "times")


def device_split(timer, fn, names, iters: int = 10) -> dict:
    """A call's launches apart, from a torch.profiler trace of ``fn``
    timed under the write flush: for each kernel whose name holds one of
    ``names``, its mean device ms a launch, and with two names, how long
    after the first kernel's end the second ends ("<b> past <a>": a
    dependent launch may start early and wait, so its own span overlaps
    the first's)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timer.times(fn, iters)
    spans = {n: [] for n in names}
    for e in prof.events():
        label = next((n for n in names if n in e.name), None)
        if e.device_type == torch.autograd.DeviceType.CUDA and label:
            spans[label].append((e.time_range.start, e.time_range.end))
    out = {n: float(np.mean([b - a for a, b in v])) / 1e3
           for n, v in spans.items() if v}
    if len(names) == 2 and len(set(map(len, spans.values()))) == 1 and \
            spans[names[0]]:
        first, second = (sorted(spans[n]) for n in names)
        out[f"{names[1]} past {names[0]}"] = float(np.mean(
            [b[1] - a[1] for a, b in zip(first, second)])) / 1e3
    return out


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def compare(got, want, tol: float, scale: float = 1.0):
    """(max abs error, |got - want| <= tol * scale + tol * |want|
    everywhere): rtol = tol and atol = tol * ``scale``."""
    g, w = got.float(), want.float()
    return max_err(g, w), bool(((g - w).abs()
                                <= tol * scale + tol * w.abs()).all())


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in fp32 (0 when both are 0)."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp(min=1e-30))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b hold the same bits (NaN and -0 included)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    it = ints[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(it), b.contiguous().view(it))


def check_same_bits(tag: str, first, second) -> None:
    """Raise unless two launches' outputs (tuples of tensors) are the same
    bits: the determinism hold, never a tolerance."""
    for i, (a, b) in enumerate(zip(first, second)):
        if not same_bits(a, b):
            raise AssertionError(f"{tag}: output {i} differs between two "
                                 f"launches on the same inputs (max "
                                 f"{max_err(a, b):.3e})")


def check_close(name: str, got, want, dtype) -> float:
    """Raise unless ``got`` is within TOL[dtype] of ``want``; returns the
    max abs error."""
    err, ok = compare(got, want, TOL[dtype])
    if not ok:
        raise AssertionError(f"{name}: outside rtol = atol = {TOL[dtype]} "
                             f"(max abs err {err:.3e})")
    return err


def check_grad(name: str, got, want, dtype):
    """``check_close``, and raise unless the relative L2 error is within
    CALL_REL_L2_BOUND[dtype]: gradients of randn inputs run to ~0.05, where
    the elementwise tolerance is mostly its absolute part (the flash
    forward's out and lse are held the same way).  Returns (max abs error,
    relative L2 error)."""
    err = check_close(name, got, want, dtype)
    rel = rel_l2(got, want)
    if not rel <= CALL_REL_L2_BOUND[dtype]:
        raise AssertionError(f"{name}: relative L2 error {rel:.3e} above "
                             f"{CALL_REL_L2_BOUND[dtype]}")
    return err, rel


def bound(nbytes, flops, dtype=torch.bfloat16):
    """(bound ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by,
          library_ms):
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

# the forward's small cases: (b, h, kv, s, dh, model_layout), each run over
# causal x window x softcap in f32 and bf16.  Ragged lengths against the
# bf16 Hopper kernel's 128-row q tiles and 64-key KV tiles (S 17: under one
# tile; 130: across one), GQA at every head dim, and the model's
# (B, S, H, Dh) layout read through transposed views with ``out=`` into one.
FLASH_CASES = ((2, 4, 2, 256, 64, False), (1, 8, 8, 200, 128, False),
               (1, 4, 1, 130, 32, False), (2, 4, 4, 130, 64, True),
               (1, 8, 2, 130, 128, True), (1, 14, 2, 130, 128, True),
               (1, 4, 2, 17, 64, True), (1, 4, 4, 17, 128, False))


def flash_phase(ops, timer):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def rand(*shape, dtype, model_layout=False):
        if model_layout:   # (B, S, H, Dh) memory seen as (B, H, S, Dh)
            b, h, s, d = shape
            return torch.randn((b, s, h, d), generator=gen, device=DEVICE,
                               dtype=torch.float32).to(dtype).transpose(1, 2)
        return torch.randn(*shape, generator=gen, device=DEVICE,
                           dtype=torch.float32).to(dtype)

    # small cases: causal x window x softcap x GQA, ragged lengths, both
    # layouts; out and lse each within TOL and CALL_REL_L2_BOUND
    cases, worst_rel = 0, collections.defaultdict(float)
    for dtype in DTYPES:
        for (b, h, kv, s, dh, ml) in FLASH_CASES:
            for causal in (True, False):
                for window, softcap in ((0, 0.0), (64, 0.0), (0, 30.0),
                                        (64, 30.0)):
                    q = rand(b, h, s, dh, dtype=dtype, model_layout=ml)
                    k = rand(b, kv, s, dh, dtype=dtype, model_layout=ml)
                    v = rand(b, kv, s, dh, dtype=dtype, model_layout=ml)
                    kw = dict(causal=causal, window=window, softcap=softcap)
                    out = (torch.empty((b, s, h, dh), dtype=dtype,
                                       device=DEVICE).transpose(1, 2)
                           if ml else None)
                    o, lse = ops.flash_attention(q, k, v, out=out, **kw)
                    ro, rlse = ops.flash_attention(q, k, v, impl="torch", **kw)
                    torch.cuda.synchronize()
                    tag = (f"flash {dtype} {(b, h, kv, s, dh)} causal={causal}"
                           f" window={window} softcap={softcap} "
                           f"model_layout={ml}")
                    if ml and o.data_ptr() != out.data_ptr():
                        raise AssertionError(f"{tag}: not written into out")
                    rels = (check_grad(tag + " out", o, ro, dtype)[1],
                            check_grad(tag + " lse", lse, rlse, dtype)[1])
                    worst_rel[dtype] = max(worst_rel[dtype], *rels)
                    cases += 1
    log(f"flash small cases: {cases} agree with the plain version (worst "
        "relative L2 of out, lse: " + ", ".join(
            f"{dt} {r:.3e}" for dt, r in worst_rel.items()) + ")")

    # the prefill shape of the serve path
    b, h, s, dh = 1, 32, PREFILL_LEN, 128
    dtype = torch.bfloat16
    q, k, v = (rand(b, h, s, dh, dtype=dtype) for _ in range(3))
    o, lse = ops.flash_attention(q, k, v, causal=True)
    ro, rlse = ops.flash_attention(q, k, v, causal=True, impl="torch")
    torch.cuda.synchronize()
    err = check_grad("flash path-shape out", o, ro, dtype)[0]
    check_grad("flash path-shape lse", lse, rlse, dtype)
    times = timer.times(lambda: ops.flash_attention(q, k, v, causal=True))
    ms = float(np.mean(times))
    plain_ms = timer.ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                    impl="torch"))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_times = timer.times(lambda: sdpa(q, k, v, is_causal=True))
    lib_ms = float(np.mean(lib_times))
    bd = flash_fwd_bound(b, h, s, dh, causal=True)
    log(f"flash (1, 32, {s}, 128) bf16 causal: max err {err:.3e}, kernel "
        f"{ms:.4f} ms ({ms / lib_ms:.2f}x sdpa), plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}); kernel "
        f"{spread(times)}; sdpa {spread(lib_times)}")
    return entry("flash_fwd", "flash_fwd.cu", "flash_attention.py:132", err,
                 ms, plain_ms, *bd, lib_ms)


def edge_lens(seed: int, b: int, mp: int, ps: int = PAGE_SIZE) -> np.ndarray:
    """Random kv_len in [1, mp * ps], slot 0 empty."""
    lens = np.random.default_rng(seed).integers(1, mp * ps + 1, size=b)
    lens[0] = 0
    return lens


def paged_inputs(gen, lens, *, h, kvh, dh, mp, dtype, quant,
                 trash_slot=None, ps=PAGE_SIZE):
    """A page pool of ``ps``-token pages with disjoint, shuffled block
    tables for ``len(lens)`` slots; ``trash_slot``'s whole table points at
    the trash page 0."""
    b = len(lens)
    n_pages = 1 + b * mp
    shape = (n_pages, ps, kvh, dh)
    q = torch.randn(b, h, dh, generator=gen, device=DEVICE).to(dtype)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=gen, device=DEVICE,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=DEVICE,
                           dtype=torch.int8)
        sc = {"k_scale": 0.005 + 0.015 * torch.rand(
                  n_pages, kvh, generator=gen, device=DEVICE),
              "v_scale": 0.005 + 0.015 * torch.rand(
                  n_pages, kvh, generator=gen, device=DEVICE)}
    else:
        kp = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        vp = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        sc = {}
    perm = torch.randperm(n_pages - 1, generator=gen, device=DEVICE) + 1
    bt = perm[: b * mp].reshape(b, mp).to(torch.int32)
    if trash_slot is not None:
        bt[trash_slot] = 0
    return q, kp, vp, bt, torch.tensor(lens, dtype=torch.int32,
                                       device=DEVICE), sc


def paged_check(ops, name, args, sc, dtype, softcap=0.0) -> float:
    """Hold one kernel call against the plain version on its inputs
    (elementwise and relative L2: ``check_grad``) and empty slots to
    zeros; returns the max abs error."""
    got = ops.paged_decode_attention(*args, softcap=softcap, **sc)
    want = ops.paged_decode_attention(*args, softcap=softcap, impl="torch",
                                      **sc)
    torch.cuda.synchronize()
    err = check_grad(name, got, want, dtype)[0]
    empty = args[4] == 0
    if not bool((got[empty] == 0).all()):
        raise AssertionError(f"{name}: an empty slot must give zeros")
    return err


def paged_bytes(lens, kp, q, quant) -> int:
    """Bytes the paged decode of ``lens`` needs: each live K/V row once
    (the tables are disjoint), the live pages' scales and table entries,
    q, out and kv_len."""
    live_tok = int(lens.sum())
    live_pages = int((-(-lens // PAGE_SIZE)).sum())
    kvh, dh = kp.shape[2], kp.shape[3]
    return (2 * live_tok * kvh * dh * kp.element_size()
            + (2 * live_pages * kvh * 4 if quant else 0)
            + live_pages * 4 + 2 * q.numel() * q.element_size()
            + len(lens) * 4)


def ptxas_registers(build, source: str, kernel: str) -> dict:
    """{mangled name: (registers, spill store bytes)} of ``kernel``'s
    instantiations in the ptxas report of ``source``'s last build."""
    path = build.BUILD_DIR / f"{source}.log"
    out, name, spill = {}, None, 0
    for line in path.read_text().splitlines() if path.exists() else ():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kernel in name:
            out[name], name = (int(m.group(1)), spill), None
    return out


def paged_phase(ops, timer):
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    mp = -(-MAX_LEN // PAGE_SIZE)
    # small cases: GQA groups (H/KV 2, 4, 8, 7 and 1), f32 and bf16, float
    # and int8 pages
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for quant in (False, True):
            for (h, kvh, dh) in ((8, 4, 64), (8, 2, 128), (16, 2, 64),
                                 (14, 2, 128), (7, 1, 64), (4, 4, 128),
                                 (4, 4, 64)):
                for softcap in (0.0, 30.0):
                    q, kp, vp, bt, kvl, sc = paged_inputs(
                        gen, edge_lens(cases, 5, 6), h=h, kvh=kvh, dh=dh,
                        mp=6, dtype=dtype, quant=quant, trash_slot=1)
                    paged_check(ops, f"paged {dtype} quant={quant} "
                                f"{(h, kvh, dh)} softcap={softcap}",
                                (q, kp, vp, bt, kvl), sc, dtype, softcap)
                    cases += 1
    # page sizes: 8 and 32 take the split kernel, 4 and 24 the walk kernel
    for ps in (8, 32, 4, 24):
        route = "split" if ps in pa.SPLIT_PAGES else "walk"
        for quant in (False, True):
            for (h, kvh, dh) in ((8, 2, 128), (8, 4, 64)):
                for softcap in (0.0, 30.0):
                    q, kp, vp, bt, kvl, sc = paged_inputs(
                        gen, edge_lens(cases, 5, 6, ps), h=h, kvh=kvh, dh=dh,
                        mp=6, dtype=torch.bfloat16, quant=quant,
                        trash_slot=1, ps=ps)
                    tag = (f"paged bf16 page {ps} quant={quant} "
                           f"{(h, kvh, dh)} softcap={softcap}")
                    ops.reset_launch_counts()
                    paged_check(ops, tag, (q, kp, vp, bt, kvl), sc,
                                torch.bfloat16, softcap)
                    if ops.launch_counts().get(f"paged_decode_{route}") != 1:
                        raise AssertionError(f"{tag}: not on the {route} "
                                             "kernel")
                    cases += 1
    log(f"paged small cases: {cases} agree with the plain version (pages "
        f"of 16, and of 8 and 32 on the split kernel, 4 and 24 on the walk "
        f"kernel)")
    regs = ptxas_registers(build, "paged_decode", "paged_decode_split_kernel")
    path_regs = {}
    for name, r in regs.items():
        m = re.search(r"paged_decode_split_kernelI(\w*?)Li1ELi128ELi16E", name)
        if m:
            kinds = m.group(1)
            path_regs[("bf16" if "bfloat16" in kinds else "f32") + " q, " + (
                "int8" if kinds.endswith("a") else "bf16") + " pages"] = r
    most = max((r for r, _ in regs.values()), default=0)
    log(f"paged_decode_split_kernel ptxas (registers, spill store bytes) at "
        f"G 1, Dh 128, page 16: {path_regs}; over all {len(regs)} "
        f"instantiations at most {most} registers, "
        f"{sum(s for _, s in regs.values())} spill store bytes")

    entries = []
    dtype = torch.bfloat16
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"paged split plan, (n_split, pages a split), at B={BATCH} x 32 KV "
        f"heads, {mp}-page tables, {n_sm} SMs: "
        f"{pa.split_plan(mp, BATCH * 32, n_sm)}")

    def held(tag, lens, table, quant, same_bits=True, yardstick=False):
        """Inputs for ``lens`` over ``table``-page tables, held against the
        plain version, launched twice for the same bits, then timed; with
        ``yardstick``, also after a read flush, each flush beside one
        ``torch.sum`` over as many contiguous bytes and an empty kernel."""
        q, kp, vp, bt, kvl, sc = paged_inputs(
            gen, lens, h=32, kvh=32, dh=128, mp=table, dtype=dtype,
            quant=quant)
        args = (q, kp, vp, bt, kvl)
        err = paged_check(ops, tag, args, sc, dtype)
        if same_bits:
            first = ops.paged_decode_attention(*args, **sc)
            second = ops.paged_decode_attention(*args, **sc)
            torch.cuda.synchronize()
            check_same_bits(tag, (first,), (second,))
        times = timer.times(lambda: ops.paged_decode_attention(*args, **sc))
        bd = bound(paged_bytes(lens, kp, q, quant),
                   4 * int(lens.sum()) * q.shape[1] * 128, dtype)
        log(f"{tag} (32 heads x 128, kv_len {lens.tolist()}): max err "
            f"{err:.3e}{', the same bits on relaunch' if same_bits else ''}"
            f", kernel {float(np.mean(times)):.4f} ms, bound {bd[0]:.4f} ms;"
            f" kernel {spread(times)}")
        if yardstick:
            same = torch.ones(paged_bytes(lens, kp, q, quant) // 4,
                              device=DEVICE)
            log(f"{tag}: " + yardstick_log(yardstick_times(
                timer, lambda: ops.paged_decode_attention(*args, **sc),
                lambda: same.sum()), "torch.sum of the same bytes"))
        return err, times, bd, args, sc

    for quant in (False, True):
        name = "paged_decode_int8" if quant else "paged_decode"
        # tables the plan splits: one slot's 32 heads (SMs left idle) and
        # 2 slots of 2000-4800 tokens in 300-page tables (past one block's
        # pages)
        for b, table, lo in ((1, mp, 600), (2, 300, 2000)):
            lens = np.random.default_rng(400 + quant + b).integers(
                lo, min(table * PAGE_SIZE, 4800) + 1, size=b)
            held(f"{name} B={b} split {pa.split_plan(table, b * 32, n_sm)}",
                 lens, table, quant)
        # the path's head geometry at B = 8 with an empty slot and a slot
        # on the trash page: correctness only
        q, kp, vp, bt, kvl, sc = paged_inputs(
            gen, edge_lens(100 + quant, 8, mp), h=32, kvh=32, dh=128, mp=mp,
            dtype=dtype, quant=quant, trash_slot=1)
        err = paged_check(ops, f"{name} B=8 edge slots", (q, kp, vp, bt, kvl),
                          sc, dtype)
        # short contexts: 16-64 tokens a slot in the serve tables
        lens = np.random.default_rng(300 + quant).integers(16, 65, size=BATCH)
        err = max(err, held(f"{name} B={BATCH} short contexts", lens, mp,
                            quant, same_bits=False, yardstick=True)[0])
        # the serve phase's geometry: B = 4 live slots of 600-1040 tokens
        # with disjoint tables
        lens = np.random.default_rng(200 + quant).integers(
            600, MAX_LEN + 1, size=BATCH)
        e, times, bd, args, sc = held(f"{name} B={BATCH} serve geometry",
                                      lens, mp, quant, yardstick=True)
        ms = float(np.mean(times))
        plain_ms = timer.ms(lambda: ops.paged_decode_attention(
            *args, impl="torch", **sc))
        log(f"{name} serve geometry: plain {plain_ms:.4f} ms")
        entries.append(entry(name, "paged_decode.cu",
                             "paged_attention.py:160", max(err, e), ms,
                             plain_ms, *bd, None))
    return entries


# the wkv6 path shapes: the full-width raw prefill, batch 4 (the serve
# geometry) and batch 1 x 1024 tokens, 32 heads of 64, chunks of 64
WKV_PATH = (BATCH, PREFILL_LEN, 32, 64)
WKV_PATH_B1 = (1, PREFILL_LEN, 32, 64)
WKV_CHUNK = 64
# kernel vs plain, both fp32 arithmetic on the same inputs: elementwise
# rtol = atol and relative L2 (the reference test's 1e-4)
WKV_TOL = 1e-4


def wkv6_inputs(gen, b, s, h, hs=64, dtype=torch.float32):
    """The distribution of tests/test_kernels.py:144-151: r, k, v ~ N(0, 1)
    in ``dtype``, logw = -exp(N(0, 1) - 2), u = 0.5 N (in ``dtype``),
    s0 = 0.1 N."""
    n = lambda *shape: torch.randn(*shape, generator=gen, device=DEVICE)
    r, k, v = (n(b, s, h, hs).to(dtype) for _ in range(3))
    logw = -torch.exp(n(b, s, h, hs) - 2.0)
    return r, k, v, logw, (0.5 * n(h, hs)).to(dtype), 0.1 * n(b, h, hs, hs)


def wkv6_check(ops, tag, args, chunk, relaunch=False) -> float:
    """Kernel against plain on ``args`` within WKV_TOL (elementwise and
    relative L2) for o and s_final, and with ``relaunch`` the same bits from
    a second launch; returns the max abs error."""
    got = ops.wkv6(*args, chunk=chunk)
    want = ops.wkv6(*args, chunk=chunk, impl="torch")
    torch.cuda.synchronize()
    errs = []
    for g, w, name in zip(got, want, ("o", "s_final")):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag} {name}: non-finite kernel output")
        err, ok = compare(g, w, WKV_TOL)
        rel = rel_l2(g, w)
        if not ok or rel > WKV_TOL:
            raise AssertionError(f"{tag} {name}: outside rtol = atol = "
                                 f"{WKV_TOL} or rel L2 {rel:.3e} > "
                                 f"{WKV_TOL} (max abs err {err:.3e})")
        errs.append(err)
    if relaunch:
        check_same_bits(tag, got, ops.wkv6(*args, chunk=chunk))
    return max(errs)


def wkv6_bound(r, u, chunk):
    """The sub-chunk form's work in one launch on these inputs: (bound ms,
    by, {"bytes", "tf32_flops", "fp32_ops", "exps", "old_ops"}).

    Bytes: r, k, v and u in their dtypes, logw and o in fp32, s0 and
    s_final.  Per (b, h, chunk of L rows) in sub-chunks of 16: the
    exponentials (one per (i, j < i, c) in the diagonal blocks, one per
    element of r_I * e^{c_prev_I - c_ref}, of k_J * e^{c_ref - c_J} for each
    later sub-chunk, of r * e^{c_prev} and k * e^{c_L - c}, and e^{c_L});
    the products as the kernel runs them in 3xTF32 on tensor cores (three
    TF32 products each, two where v is bf16 and so exact in TF32): the off-
    diagonal scores, the scores times V over the blocks on and below the
    diagonal, (r * e^{c_prev}) S and the state update; the fp32 operations
    on CUDA cores (four a diagonal (pair, channel): difference, clamp,
    two multiply-adds; two a bonus channel; two a factor element; the
    cumulative sum).  Rates: 3.35 TB/s, 495 TFLOP/s TF32 dense, 67 TFLOP/s
    fp32 with an exponential counted as one operation; the bound is the
    largest of the three times.  ``old_ops`` is the first port's count
    (the full lower triangle, one exponential per (i, j < i, c), all at the
    fp32 peak), kept to compare."""
    b, s, h, hs = r.shape
    el = r.numel()
    nbytes = 3 * el * r.element_size() + 2 * el * 4 \
        + h * hs * u.element_size() + 2 * b * h * hs * hs * 4
    nl, sub = chunk, 16
    rows = [min(sub, nl - lo) for lo in range(0, nl, sub)]
    diag_pairs = sum(n * (n - 1) // 2 for n in rows)
    later = nl - rows[0]                       # rows of sub-chunks I >= 1
    earlier = sum(sub * i * n for i, n in enumerate(rows))  # 16 I x rows
    factors = later * hs + sum(sub * i for i in range(len(rows))) * hs \
        + 2 * nl * hs + hs
    exps = diag_pairs * hs + factors
    vt = 2 if r.dtype == torch.bfloat16 else 3
    below = sum(n * (sum(rows[:i]) + n) for i, n in enumerate(rows))
    tf32 = 2 * (3 * earlier * hs + vt * below * hs + 3 * nl * hs * hs
                + vt * nl * hs * hs)
    fp32 = 4 * diag_pairs * hs + 2 * nl * hs + 2 * factors + nl * hs
    n = b * h * (s // nl)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_tc = n * tf32 / 495e12 * 1e3
    t_ops = n * (fp32 + exps) / PEAK_FLOPS[torch.float32] * 1e3
    ms = max(t_bytes, t_tc, t_ops)
    by = "bytes" if ms == t_bytes else "operations"
    pairs = nl * (nl - 1) // 2
    old = pairs * hs + 2 * nl * hs + hs + 4 * pairs * hs + 3 * nl * hs \
        + 2 * (pairs + nl) * hs + 2 * 2 * nl * hs * hs + 5 * nl * hs + hs * hs
    return ms, by, {"bytes": nbytes, "tf32_flops": n * tf32,
                    "fp32_ops": n * fp32, "exps": n * exps,
                    "old_ops": n * old,
                    "old_ms": max(t_bytes, n * old / PEAK_FLOPS[
                        torch.float32] * 1e3)}


def wkv6_registers(build) -> str:
    """Registers and spill store bytes of each ``wkv6_kernel``
    instantiation (element type, value columns a block) in ptxas's report
    of the last build."""
    out = []
    for name, (regs, spill) in sorted(ptxas_registers(
            build, "wkv6", "wkv6_kernel").items()):
        nc = re.search(r"Li(\d+)E", name)
        out.append(f"wkv6_kernel<{'bf16' if 'bfloat16' in name else 'f32'}, "
                   f"{nc.group(1) if nc else '?'}> {regs} ({spill} B "
                   "spilled)")
    return "; ".join(out)


@contextlib.contextmanager
def wkv6_grid(kw, n):
    """``kernels/wkv6.py`` ``plan`` forced to ``n`` blocks a head while the
    block runs (``n`` None: the plan left as it is)."""
    if n is None:
        yield
        return
    plan, kw.plan = kw.plan, (lambda b, h: n)
    try:
        yield
    finally:
        kw.plan = plan


def wkv6_small_cases(ops, gen, tag) -> int:
    """The small wkv6 cases held against the plain version (raises on the
    first outside WKV_TOL); returns their count."""
    cases = 0
    for s, chunk in ((128, 32), (256, 64), (64, 64), (32, 64), (6, 64),
                     (60, 64), (120, 60)):
        for dtype in (torch.float32, torch.bfloat16):
            args = wkv6_inputs(gen, 2, s, 2, dtype=dtype)
            wkv6_check(ops, f"wkv6 {tag} {dtype} s={s} chunk={chunk}", args,
                       chunk)
            cases += 1
    wide = torch.randn(2, 128, 3, 2, 64, generator=gen, device=DEVICE)
    args = wkv6_inputs(gen, 2, 128, 2)
    args = (wide[:, :, 0], wide[:, :, 1], wide[:, :, 2]) + args[3:]
    wkv6_check(ops, f"wkv6 {tag} strided r, k, v", args, 64)
    # rows one element off the 16-byte grid: the kernel's plain loads
    for dtype in (torch.float32, torch.bfloat16):
        args = wkv6_inputs(gen, 2, 128, 2, dtype=dtype)
        odd = tuple(torch.randn(2, 128, 2, 65, generator=gen, device=DEVICE)
                    .to(dtype)[..., 1:] for _ in range(3))
        wkv6_check(ops, f"wkv6 {tag} {dtype} r, k, v one element off 16 "
                   "bytes", odd + args[3:], 64)
    # strong decay (tests/test_kernels.py:166): logw = -50 everywhere, and
    # -100, where a factor e^{+100} would overflow fp32
    for s, chunk, w in ((64, 16, -50.0), (256, 64, -50.0), (256, 64, -100.0)):
        one = torch.ones(1, s, 1, 64, device=DEVICE)
        wkv6_check(ops, f"wkv6 {tag} strong decay {w} chunk {chunk}", (
            one, one, one, torch.full_like(one, w),
            torch.zeros(1, 64, device=DEVICE),
            torch.zeros(1, 1, 64, 64, device=DEVICE)), chunk)
    return cases + 6


def wkv6_holds(ops) -> dict:
    """Every wkv6 case held against the plain version (raises on the first
    outside WKV_TOL): on each grid of ``kernels/wkv6.py`` ``plan`` (1 and 2
    blocks a head, forced), the CPU tests' (s, chunk) cases plus chunks of
    6 and 60 rows (a short last sub-chunk), in f32 and bf16; r, k, v read
    through strides, and one element off the 16-byte grid in f32 and bf16;
    strong decay (logw = -50 everywhere) in chunks of 16 and 64, and -100
    in chunks of 64 (e^{+100} would overflow fp32: a factor with a positive
    exponent shows); then the two path shapes in bf16 on the plan's grid,
    each launched twice for the same bits.  Returns {"cases", "path":
    {shape: (args, max err)}}."""
    from repro_torch.kernels import wkv6 as kw
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    grids = (1, 2) if hasattr(kw, "plan") else (None,)
    cases = 0
    for n in grids:
        with wkv6_grid(kw, n):
            cases += wkv6_small_cases(ops, gen, f"grid {n}")
    log(f"wkv6 small cases: {cases} agree with the plain version on grids "
        f"{list(grids)} (rtol = atol = rel L2 = {WKV_TOL})")
    path = {}
    for shape in (WKV_PATH, WKV_PATH_B1):
        args = wkv6_inputs(gen, *shape, dtype=torch.bfloat16)
        path[shape] = (args, wkv6_check(ops, f"wkv6 path shape {shape}",
                                        args, WKV_CHUNK, relaunch=True))
    log(f"wkv6 path shapes {list(path)} bf16: within {WKV_TOL} of the plain "
        "version, the same bits on relaunch")
    return {"cases": cases, "path": path}


def wkv6_phase(ops, timer):
    """``wkv6_holds``, then each path shape timed as the path calls it
    (``ops.wkv6``: the grid of ``kernels/wkv6.py`` ``plan``) and, held
    first, on the other grid (1 or 2 blocks a head, the plan forced;
    skipped in a tree without the plan), beside the plain version and the
    bound (no single PyTorch call computes it); the kernel's ptxas
    registers logged."""
    from repro_torch.kernels import build
    from repro_torch.kernels import wkv6 as kw
    holds = wkv6_holds(ops)
    log(f"wkv6 ptxas: {wkv6_registers(build)}")
    for shape, (args, err) in holds["path"].items():
        times = timer.times(lambda: ops.wkv6(*args, chunk=WKV_CHUNK))
        ms = float(np.mean(times))
        other = ""
        if hasattr(kw, "plan"):
            n = 3 - kw.plan(shape[0], shape[2])
            with wkv6_grid(kw, n):
                e = wkv6_check(ops, f"wkv6 path shape {shape} grid {n}",
                               args, WKV_CHUNK)
                t = timer.times(lambda: ops.wkv6(*args, chunk=WKV_CHUNK))
            other = (f"; plan {3 - n} blocks a head, {n}: "
                     f"{float(np.mean(t)):.4f} ms (max err {e:.3e})")
        bd_ms, by, work = wkv6_bound(args[0], args[4], WKV_CHUNK)
        plain_ms = timer.ms(lambda: ops.wkv6(*args, chunk=WKV_CHUNK,
                                             impl="torch"), iters=5)
        log(f"wkv6 {shape} bf16 r/k/v, chunk {WKV_CHUNK}: kernel {ms:.4f} "
            f"ms ({spread(times)}){other}; plain {plain_ms:.4f} ms; max err "
            f"{err:.3e}; bound {bd_ms:.4f} ms ({by}: "
            f"{work['bytes'] / 1e6:.1f} MB, {work['tf32_flops'] / 1e9:.3f} G "
            f"TF32 flops, {work['fp32_ops'] / 1e9:.3f} G fp32 operations and "
            f"{work['exps'] / 1e6:.1f} M exponentials; the first port's "
            f"count {work['old_ops'] / 1e9:.3f} G operations, "
            f"{work['old_ms']:.4f} ms)")
        if shape == WKV_PATH:
            res = entry("wkv6", "wkv6.cu", "wkv6.py:98", err, ms, plain_ms,
                        bd_ms, by, None)
    return res


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def serve_run(T, ops, sched_mod, cfg, params, pol, mode):
    rng = np.random.default_rng(SEED + 2)
    sched = sched_mod.ContinuousScheduler(
        params, cfg, pol, batch=BATCH, max_len=MAX_LEN,
        prefill_len=PREFILL_LEN, cache_mode=mode, page_size=PAGE_SIZE,
        cache_dtype=torch.bfloat16, device=DEVICE)
    for rid in range(N_REQUESTS):
        n = int(rng.integers(600, PREFILL_LEN + 1))
        sched.submit(sched_mod.Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab_size, size=n,
                                         dtype=np.int32),
            max_new_tokens=int(rng.integers(4, 17))))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    done = sched.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st = sched.stats
    if len(done) != N_REQUESTS or any(
            r.output is None or len(r.output) == 0 for r in done):
        raise AssertionError(f"{mode}: not every request produced tokens")
    if st.nonfinite_logits:
        raise AssertionError(f"{mode}: {st.nonfinite_logits} non-finite "
                             "logit rows")
    if sched.allocator.in_use or \
            sched.allocator.available != sched.num_pages - 1:
        raise AssertionError(f"{mode}: pages not all returned "
                             f"({sched.allocator.in_use} in use)")
    for k in SERVE_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"{mode}: kernel {k} never launched")
    if counts.get("paged_decode_split", 0) != counts["paged_decode"]:
        raise AssertionError(f"{mode}: paged decode off the split kernel")
    step_ms = 1e3 * st.decode_s / max(st.decode_steps - 1, 1)
    log(f"serve {mode}: {len(done)} requests, {st.prefills} prefills, "
        f"{st.decode_steps} decode steps, {st.useful_tokens} tokens in "
        f"{st.wall_s:.3f} s ({st.tokens_per_s:.1f} tok/s), decode "
        f"{step_ms:.3f} ms/step ({st.decode_tokens_per_s:.1f} tok/s), "
        f"launches {counts}, KV cache {st.cache_bytes / 2**30:.3f} GiB")
    return counts


# one held kernel call: max abs error, within its tolerance, largest
# relative L2 error and largest RMS over the call's plain outputs
Call = collections.namedtuple("Call", "err ok rel rms")


@contextlib.contextmanager
def held_against_plain(ops, record, spec):
    """While active, every call of a kernel named in ``spec`` through
    ``ops`` (impl None) is followed by its plain version on the same
    inputs, and ``record[kernel]`` collects a ``Call`` of each.
    ``spec[kernel]`` is (dtype, rms): each output is held to TOL[dtype]
    (dtype None: that of the call's first argument, as the training path
    mixes bf16 activations and the fp32 optimizer state), with the
    absolute part TOL times the plain output's RMS when ``rms`` is true: a
    dot product's rounding error scales with the magnitude of its terms,
    and where outputs run to 10^2 a fixed floor fails wherever terms
    cancel.  LAMB's moment kernel is elementwise: over a group of more
    than HOLD_SLICE elements its plain version runs a slice at a time
    (gemma2's 1.18 G-element table would need ~20 GB of plain temporaries
    beside the training state), each slice held, the relative L2 error
    taken over the whole group."""
    saved = {name: getattr(ops, name) for name in spec}

    def held(name, fn):
        dtype, by_rms = spec[name]

        def call(*args, impl=None, **kw):
            got = fn(*args, impl=impl, **kw)
            if impl is None:
                kw.pop("out", None)
                tol = TOL[dtype or args[0].dtype]
                gots = got if isinstance(got, tuple) else (got,)
                n = args[0].numel()
                if name == "lamb_moments" and n > HOLD_SLICE:
                    cuts = [slice(i, i + HOLD_SLICE)
                            for i in range(0, n, HOLD_SLICE)]
                else:
                    cuts = [slice(None)]
                err, ok = 0.0, True
                diff2, want2 = [0.0] * len(gots), [0.0] * len(gots)
                for cut in cuts:
                    part = args if len(cuts) == 1 else \
                        tuple(a[cut] for a in args)
                    want = fn(*part, impl="torch", **kw)
                    wants = want if isinstance(want, tuple) else (want,)
                    for i, (g, w) in enumerate(zip(gots, wants)):
                        g = g if len(cuts) == 1 else g[cut]
                        want2[i] += float(w.float().square().sum())
                        diff2[i] += float((g.float() - w.float()).square()
                                          .sum())
                        sc = float(w.float().square().mean().sqrt()) \
                            if by_rms else 1.0
                        e, good = compare(g, w, tol, sc)
                        err, ok = max(err, e), ok and good
                    del want, wants
                record[name].append(Call(
                    err, ok, max((d / max(w2, 1e-60)) ** 0.5
                                 for d, w2 in zip(diff2, want2)),
                    max((w2 / g.numel()) ** 0.5
                        for w2, g in zip(want2, gots))))
            return got
        return call

    for name, fn in saved.items():
        setattr(ops, name, held(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def call_summary(record) -> dict:
    """Per kernel: calls, calls outside tolerance, max abs error and max
    relative L2 error over the ``Call``s of ``record``."""
    return {"calls": {k: len(v) for k, v in record.items()},
            "calls_outside": {k: sum(not c.ok for c in v)
                              for k, v in record.items()},
            "call_max_err": {k: max((c.err for c in v), default=0.0)
                             for k, v in record.items()},
            "call_max_rel": {k: max((c.rel for c in v), default=0.0)
                             for k, v in record.items()}}


def path_parity(T, serve_step, ops, cfg, params, pol, mode) -> dict:
    """One request's prefill and 4 decode steps through the kernels and
    through the plain versions, fed the same tokens.  Each kernel call of
    the kernel path is also held against its plain version on that call's
    inputs (tolerance TOL), so rounding does not compound over the layers.
    Returns the readings; ``check_parity`` judges them."""
    rng = np.random.default_rng(SEED + 3)
    n = PREFILL_LEN * 3 // 4 + 9           # 777 tokens at the 1024 bucket
    prompt = np.zeros((1, PREFILL_LEN), np.int32)
    prompt[0, :n] = rng.integers(0, cfg.vocab_size, size=n)
    toks = torch.from_numpy(prompt).to(DEVICE)
    mp = -(-MAX_LEN // PAGE_SIZE)
    paged = T.PagedCacheConfig(page_size=PAGE_SIZE, num_pages=1 + mp,
                               quantized=(mode == "paged_int8"))
    record = {"flash_attention": [], "paged_decode_attention": []}
    feed, logits = None, {}
    with held_against_plain(ops, record, {k: (pol.compute_dtype, False)
                                          for k in record}):
        for impl in (None, "torch"):
            state = T.init_decode_state(cfg, 1, MAX_LEN, pol.compute_dtype,
                                        paged=paged, device=DEVICE)
            T.set_block_tables(state, np.arange(1, 1 + mp, dtype=np.int32))
            lg, state = serve_step.prefill_into_slot(
                params, toks, n, state, 0, cfg, pol, impl=impl)
            seq = [lg[None]]
            if feed is None:
                feed = [int(lg.argmax())]
            for i in range(4):
                tok = torch.tensor([[feed[i]]], device=DEVICE)
                lg, state = T.decode_step(params, tok, state, cfg, pol,
                                          impl=impl)
                seq.append(lg)
                if impl is None and len(feed) < 4:
                    feed.append(int(lg.argmax()))
            logits[impl] = torch.cat(seq).float()
    a, b = logits[None], logits["torch"]
    res = {"mode": mode, "dtype": pol.compute_dtype,
           "finite": bool(torch.isfinite(a).all()),
           "rel_l2": float((a - b).norm() / b.norm()),
           "max_abs": float((a - b).abs().max()), **call_summary(record)}
    log(f"path parity {mode} {pol.compute_dtype}: prefill + 4 decode logits,"
        f" kernels vs plain: rel L2 {res['rel_l2']:.3e} (bound "
        f"{LOGIT_REL_L2_BOUND[pol.compute_dtype]}), max abs "
        f"{res['max_abs']:.3e}, max |logit| {float(b.abs().max()):.3f}; "
        f"each kernel call vs plain on its inputs (tol "
        f"{TOL[pol.compute_dtype]}): " + ", ".join(
            f"{k} {res['calls_outside'][k]}/{res['calls'][k]} outside, max "
            f"err {res['call_max_err'][k]:.3e}, max rel L2 "
            f"{res['call_max_rel'][k]:.3e}" for k in record))
    return res


def check_parity(res: dict) -> None:
    mode = res["mode"]
    if not res["finite"]:
        raise AssertionError(f"{mode}: non-finite kernel-path logits")
    for k, n in res["calls"].items():
        if n == 0:
            raise AssertionError(f"{mode}: {k} was never called")
        if res["calls_outside"][k]:
            raise AssertionError(f"{mode}: {res['calls_outside'][k]} of {n} "
                                 f"{k} calls disagree with the plain version")
    if not res["rel_l2"] <= LOGIT_REL_L2_BOUND[res["dtype"]]:
        raise AssertionError(f"{mode}: kernel path departs from the plain "
                             f"path (rel L2 {res['rel_l2']:.3e})")
    # the paged calls also as a whole: elementwise, TOL is about half a
    # typical output value (~0.06 at the serve geometry)
    rel = res["call_max_rel"].get("paged_decode_attention")
    if rel is not None and not rel <= CALL_REL_L2_BOUND[res["dtype"]]:
        raise AssertionError(f"{mode}: a paged decode call departs from "
                             f"the plain version (rel L2 {rel:.3e})")

# ---------------------------------------------------------------------------
# the prefix cache and the cohort scheduler (deepseek-7b, bf16)
# ---------------------------------------------------------------------------

# the serve CLI's --prefix-cache rule: the bucket, one page for the first
# decode writes, and a bucket of headroom for a suffix at offset `covered`
PREFIX_MAX_LEN = PREFILL_LEN + PAGE_SIZE + PREFILL_LEN      # 2064
PREFIX_HEAD = 512                 # the two shared heads, 32 pages each
SUFFIX_PROMPT = PREFILL_LEN * 3 // 4 + 9                    # 777 tokens
# suffix prefill (a 512-token head, then the rest at start 512) against
# the whole prompt's prefill, logits rel L2 over the prefill and 4 decode
# steps.  The suffix attends through the plain form in fp32 where the
# whole prefill's flash forward rounds P to bf16, and that compounds over
# 30 layers as the kernels-vs-plain path does: bf16 pages 3.662e-2 on an
# H100, under LOGIT_REL_L2_BOUND.  int8 pages: the suffix's queries also
# read the head's KV back quantised, where the whole prefill attends its
# own unquantised KV: 3.980e-2 at the first reading (H100 80GB HBM3,
# 700 W; the seeds fix the data); the bound is 1.5x that
SUFFIX_REL_L2_BOUND = {"paged": LOGIT_REL_L2_BOUND[torch.bfloat16],
                       "paged_int8": 6e-2}
COW_VALID = 5                     # rows the copy-on-write check keeps


def prefix_trace(vocab: int):
    """(prompt, budget) of 12 requests: two seeded 512-token heads, each
    followed by 64-480 fresh tokens, and two exact repeats.  Requests 0
    and 2 seed heads 0 and 1, and 1 and 3 repeat them right after, so the
    four are admitted together: each repeat is a full hit, and both of a
    pair's slots hold the shared partial last page (no prompt is a
    multiple of 16 tokens) when decoding starts, so the first decode write
    copies it.  Requests 4-11 share a head each: hits of 32 pages and a
    suffix prefill at start 512."""
    rng = np.random.default_rng(SEED + 4)
    heads = [rng.integers(0, vocab, size=PREFIX_HEAD, dtype=np.int32)
             for _ in range(2)]

    def fresh(h):
        n = int(rng.integers(64, 481))
        while (PREFIX_HEAD + n) % PAGE_SIZE == 0:
            n = int(rng.integers(64, 481))
        return np.concatenate(
            [heads[h], rng.integers(0, vocab, size=n, dtype=np.int32)])

    seeds = [fresh(0), fresh(1)]
    prompts = [seeds[0], seeds[0], seeds[1], seeds[1]] + [
        fresh(i % 2) for i in range(8)]
    return [(p, int(rng.integers(4, 17))) for p in prompts]


def prefix_run(ops, sched_mod, cfg, params, pol, mode, prefix_cache):
    """The prefix trace through ``ContinuousScheduler`` (batch 4, bucket
    1024, max_len 2064), launch counts zeroed just before and read just
    after; every request must produce tokens, every logit be finite, every
    page come back, both kernels launch (the paged decode on the split
    kernel) and, with the prefix cache, hits, full hits, copies and saved
    prefill tokens all occur."""
    tag = f"prefix {mode} {'shared' if prefix_cache else 'unshared'}"
    sched = sched_mod.ContinuousScheduler(
        params, cfg, pol, batch=BATCH, max_len=PREFIX_MAX_LEN,
        prefill_len=PREFILL_LEN, cache_mode=mode, page_size=PAGE_SIZE,
        cache_dtype=torch.bfloat16, prefix_cache=prefix_cache, device=DEVICE)
    trace = prefix_trace(cfg.vocab_size)
    for rid, (prompt, new) in enumerate(trace):
        sched.submit(sched_mod.Request(rid=rid, prompt=prompt,
                                       max_new_tokens=new))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    done = sched.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st = sched.stats
    alloc = sched.allocator
    if len(done) != len(trace) or any(
            r.output is None or len(r.output) == 0 for r in done):
        raise AssertionError(f"{tag}: not every request produced tokens")
    if st.nonfinite_logits:
        raise AssertionError(f"{tag}: {st.nonfinite_logits} non-finite "
                             "logit rows")
    if alloc.in_use or alloc.available != sched.num_pages - 1:
        raise AssertionError(f"{tag}: pages not all returned "
                             f"({alloc.in_use} in use)")
    for k in SERVE_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"{tag}: kernel {k} never launched")
    if counts.get("paged_decode_split", 0) != counts["paged_decode"]:
        raise AssertionError(f"{tag}: paged decode off the split kernel")
    if prefix_cache and not (st.prefix_hits and st.prefix_full_hits and
                             st.cow_copies and st.prefill_tokens_saved):
        raise AssertionError(f"{tag}: the prefix cache was not exercised "
                             f"({st})")
    step_ms = 1e3 * st.decode_s / max(st.decode_steps - 1, 1)
    log(f"serve {tag}: {len(done)} requests, {st.prefills} prefills "
        f"({st.prefill_tokens} tokens), hits {st.prefix_hits}/"
        f"{st.prefix_lookups} ({st.prefix_full_hits} full), "
        f"{st.pages_shared} pages shared, {st.prefill_tokens_saved} prefill "
        f"tokens saved, {st.cow_copies} COW copies, {alloc.cached} cached "
        f"pages held, {alloc.reclaimed} reclaimed; {st.decode_steps} decode "
        f"steps, {st.useful_tokens} tokens in {st.wall_s:.3f} s, decode "
        f"{step_ms:.3f} ms/step, launches {counts}")
    return {"counts": counts, "stats": st,
            "outputs": {r.rid: np.asarray(r.output) for r in done}}


def first_difference(a, b):
    """Index of the first differing token over the common length, or
    None."""
    n = min(len(a), len(b))
    diff = np.flatnonzero(np.asarray(a[:n]) != np.asarray(b[:n]))
    return int(diff[0]) if len(diff) else None


def check_prefix_runs(runs: dict) -> None:
    """Holds across the three prefix runs.  ``paged``: each full hit's
    output (requests 1 and 3) equals its seed's over their common length,
    in bits (the reference's own claim), and the shared run computes fewer
    prefill tokens than the unshared one.  ``paged_int8``, whose copy is
    requantised: logged only.  Both: how many requests match the unshared
    ``paged`` run in bits."""
    base = runs["unshared"]
    if not runs["paged"]["stats"].prefill_tokens < \
            base["stats"].prefill_tokens:
        raise AssertionError("prefix paged: no prefill tokens saved against "
                             "the unshared run")
    for mode in ("paged", "paged_int8"):
        out = runs[mode]["outputs"]
        for seed, rep in ((0, 1), (2, 3)):
            at = first_difference(out[rep], out[seed])
            log(f"prefix {mode}: full hit {rep} vs its seed {seed}: "
                + ("the same tokens over "
                   f"{min(len(out[rep]), len(out[seed]))}" if at is None else
                   f"first differs at step {at}"))
            if mode == "paged" and at is not None:
                raise AssertionError(f"prefix paged: full hit {rep} departs "
                                     f"from its seed {seed} at step {at}")
        same = sum(np.array_equal(out[r], base["outputs"][r]) for r in out)
        firsts = {r: first_difference(out[r], base["outputs"][r])
                  for r in out}
        log(f"prefix {mode}: {same} of {len(out)} requests equal the "
            f"unshared run's tokens in bits (first differing step by rid: "
            f"{firsts})")


def suffix_parity(T, serve_step, ops, cfg, params, pol, mode) -> dict:
    """(b) A 777-token prompt whole into slot 0 and as a 512-token prefill
    plus a suffix prefill at start 512 into slot 1 (both prefills of the
    1024 bucket: the flash forward), then 4 decode steps of both fed the
    same tokens, every flash and paged-decode call held against its plain
    version.  (c) Then ``copy_page`` on that pool: slot 1's last page into
    a spare page, keeping ``COW_VALID`` rows."""
    rng = np.random.default_rng(SEED + 3)
    prompt = rng.integers(0, cfg.vocab_size, size=SUFFIX_PROMPT,
                          dtype=np.int32)
    mp = -(-PREFIX_MAX_LEN // PAGE_SIZE)
    paged = T.PagedCacheConfig(page_size=PAGE_SIZE, num_pages=2 + 2 * mp,
                               quantized=(mode == "paged_int8"))
    state = T.init_decode_state(cfg, 2, PREFIX_MAX_LEN, pol.compute_dtype,
                                paged=paged, device=DEVICE)
    rows = np.arange(1, 1 + 2 * mp, dtype=np.int32).reshape(2, mp)
    T.set_block_tables(state, rows)

    def bucket(toks):
        t = np.zeros((1, PREFILL_LEN), np.int32)
        t[0, : len(toks)] = toks
        return torch.from_numpy(t).to(DEVICE)

    record = {"flash_attention": [], "paged_decode_attention": []}
    with held_against_plain(ops, record, {k: (pol.compute_dtype, False)
                                          for k in record}):
        whole, state = serve_step.prefill_into_slot(
            params, bucket(prompt), SUFFIX_PROMPT, state, 0, cfg, pol)
        serve_step.prefill_into_slot(params, bucket(prompt[:PREFIX_HEAD]),
                                     PREFIX_HEAD, state, 1, cfg, pol)
        sfx, state = serve_step.prefill_into_slot(
            params, bucket(prompt[PREFIX_HEAD:]), SUFFIX_PROMPT - PREFIX_HEAD,
            state, 1, cfg, pol, start=PREFIX_HEAD)
        seqs = [[whole], [sfx]]
        feed = int(whole.argmax())
        for _ in range(4):
            tok = torch.full((2, 1), feed, device=DEVICE)
            lg, state = T.decode_step(params, tok, state, cfg, pol)
            seqs[0].append(lg[0])
            seqs[1].append(lg[1])
            feed = int(lg[0].argmax())
    a, b = (torch.stack(x).float() for x in seqs)
    res = {"mode": mode, "dtype": pol.compute_dtype,
           "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
           "rel_l2": rel_l2(b, a), "max_abs": max_err(b, a),
           "tokens_equal": bool(torch.equal(a.argmax(-1), b.argmax(-1))),
           **call_summary(record)}
    log(f"suffix parity {mode}: {SUFFIX_PROMPT}-token prompt, suffix at "
        f"{PREFIX_HEAD} vs whole, prefill + 4 decode logits: rel L2 "
        f"{res['rel_l2']:.3e} (bound {SUFFIX_REL_L2_BOUND[mode]}), max abs "
        f"{res['max_abs']:.3e}, greedy tokens equal {res['tokens_equal']}; "
        "each kernel call vs plain: " + ", ".join(
            f"{k} {res['calls_outside'][k]}/{res['calls'][k]} outside, max "
            f"err {res['call_max_err'][k]:.3e}, max rel L2 "
            f"{res['call_max_rel'][k]:.3e}" for k in record))
    if not res["finite"]:
        raise AssertionError(f"suffix parity {mode}: non-finite logits")
    for k, n in res["calls"].items():
        if n == 0 or res["calls_outside"][k]:
            raise AssertionError(f"suffix parity {mode}: {k}: "
                                 f"{res['calls_outside'][k]} of {n} calls "
                                 "outside tolerance")
    if not res["rel_l2"] <= SUFFIX_REL_L2_BOUND[mode]:
        raise AssertionError(f"suffix parity {mode}: suffix departs from the "
                             f"whole prefill (rel L2 {res['rel_l2']:.3e})")
    cow_check(T, state, mode, src=int(rows[1][(SUFFIX_PROMPT + 3)
                                              // PAGE_SIZE]),
              dst=paged.num_pages - 1)

    def wall_ms(fn, n=3):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t))
        return out

    whole_ms = wall_ms(lambda: serve_step.prefill_into_slot(
        params, bucket(prompt), SUFFIX_PROMPT, state, 0, cfg, pol))
    sfx_ms = wall_ms(lambda: serve_step.prefill_into_slot(
        params, bucket(prompt[PREFIX_HEAD:]), SUFFIX_PROMPT - PREFIX_HEAD,
        state, 1, cfg, pol, start=PREFIX_HEAD))
    log(f"prefill wall {mode} (host clock, synchronized, 3 runs): whole "
        f"prompt {', '.join(f'{t:.1f}' for t in whole_ms)} ms; suffix at "
        f"{PREFIX_HEAD} (1024-token bucket, plain attention over "
        f"{PREFIX_MAX_LEN} keys) {', '.join(f'{t:.1f}' for t in sfx_ms)} ms")
    return res


def cow_check(T, state, mode, src: int, dst: int) -> None:
    """(c) ``copy_page(src -> dst, COW_VALID)`` on the serve pool, every
    layer: bf16 keeps the source's rows in bits; int8 dequantises within
    one quantisation step (the copy's scale) of the source's values, with
    a scale no larger than the source's; past ``COW_VALID`` every row is 0
    and the source keeps its bits."""
    caches = [st["cache"] for st in state["blocks"]]
    before = [{k: c[k][src].clone() for k in c if k != "block_table"}
              for c in caches]
    T.copy_page(state, src, dst, COW_VALID)
    torch.cuda.synchronize()
    worst, widest = 0.0, 0.0
    for layer, (c, old) in enumerate(zip(caches, before)):
        for pk, sk in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
            if not same_bits(c[pk][src], old[pk]):
                raise AssertionError(f"cow {mode}: layer {layer} source "
                                     "page changed")
            got, want = c[pk][dst], old[pk]
            if got[COW_VALID:].any():
                raise AssertionError(f"cow {mode}: layer {layer} rows past "
                                     f"{COW_VALID} not zero")
            if sk not in c:
                if not same_bits(got[:COW_VALID], want[:COW_VALID]):
                    raise AssertionError(f"cow {mode}: layer {layer} {pk} "
                                         "kept rows differ")
                continue
            scale, src_scale = c[sk][dst], old[sk]
            err = (got[:COW_VALID].float() * scale[None, :, None]
                   - want[:COW_VALID].float() * src_scale[None, :, None])
            step = err.abs().amax(dim=(0, 2)) / scale.clamp(min=1e-30)
            worst = max(worst, float(step.max()))
            widest = max(widest, float((scale / src_scale.clamp(
                min=1e-30)).max()))
            if bool((step > 1.0).any()) or \
                    bool((scale > src_scale * (1 + 1e-6)).any()):
                raise AssertionError(
                    f"cow {mode}: layer {layer} {pk}: copy off by "
                    f"{float(step.max()):.3f} steps or its scale above the "
                    "source's")
    log(f"cow {mode}: page {src} -> {dst} keeping {COW_VALID} rows, "
        f"{len(caches)} layers: "
        + ("kept rows in bits, the rest 0" if mode == "paged" else
           f"worst error {worst:.3f} of a quantisation step, largest scale "
           f"{widest:.4f} of the source's, the rest 0"))


def cohort_run(ops, sched_mod, cfg, params, pol) -> dict:
    """(d) 8 requests of 600-1024 prompt tokens and 4-16 new through
    ``CohortScheduler`` (batch 4, max_len 1040; each cohort's first prompt
    is 1024 tokens, so its left-padded prefill takes the flash forward at
    (4, 32, 1024, 128)), every flash call held against its plain version.
    Launch counts zeroed just before and read just after: the flash
    forward once a layer a cohort; 2 cohorts; each output its budget long;
    ``useful_tokens`` and ``wasted_slots`` as counted on the host from the
    budgets; finite logits."""
    rng = np.random.default_rng(SEED + 5)
    lens = rng.integers(600, PREFILL_LEN + 1, size=N_REQUESTS)
    lens[::BATCH] = PREFILL_LEN
    budgets = [int(x) for x in rng.integers(4, 17, size=N_REQUESTS)]
    sched = sched_mod.CohortScheduler(params, cfg, pol, batch=BATCH,
                                      max_len=MAX_LEN, device=DEVICE)
    for rid, (n, new) in enumerate(zip(lens, budgets)):
        sched.submit(sched_mod.Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab_size, size=int(n),
                                         dtype=np.int32),
            max_new_tokens=new))
    record = {"flash_attention": []}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with held_against_plain(ops, record, {"flash_attention":
                                          (pol.compute_dtype, False)}):
        done = sched.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st = sched.stats
    useful = sum(budgets)
    wasted = sum(sum(b <= step for b in budgets[c: c + BATCH])
                 for c in range(0, N_REQUESTS, BATCH)
                 for step in range(1, max(budgets[c: c + BATCH])))
    calls = call_summary(record)
    log(f"serve cohort: {len(done)} requests in {st.cohorts} cohorts, "
        f"{st.decode_steps} decode steps, {st.useful_tokens} useful tokens "
        f"(host count {useful}), {st.wasted_slots} wasted slots (host count "
        f"{wasted}), utilisation {st.slot_utilisation:.3f}, "
        f"{st.wall_s:.3f} s (held calls included), launches {counts}; "
        f"flash calls vs plain: {calls['calls_outside']['flash_attention']}/"
        f"{calls['calls']['flash_attention']} outside, max err "
        f"{calls['call_max_err']['flash_attention']:.3e}, max rel L2 "
        f"{calls['call_max_rel']['flash_attention']:.3e}")
    if st.cohorts != N_REQUESTS // BATCH:
        raise AssertionError(f"cohort: {st.cohorts} cohorts")
    by_rid = {r.rid: r for r in done}
    if sorted(by_rid) != list(range(N_REQUESTS)) or any(
            len(by_rid[r].output) != budgets[r] for r in by_rid):
        raise AssertionError("cohort: an output is not its budget long")
    if (st.useful_tokens, st.wasted_slots) != (useful, wasted):
        raise AssertionError("cohort: useful tokens / wasted slots differ "
                             "from the host's count")
    if st.nonfinite_logits:
        raise AssertionError(f"cohort: {st.nonfinite_logits} non-finite "
                             "logit rows")
    want = st.cohorts * cfg.n_layers
    if counts["flash_fwd"] != want or counts.get(
            f"flash_fwd_s{PREFILL_LEN}", 0) != want:
        raise AssertionError(f"cohort: flash launches {counts} (want {want} "
                             f"at S {PREFILL_LEN})")
    n = calls["calls"]["flash_attention"]
    if n != want or calls["calls_outside"]["flash_attention"] or \
            calls["call_max_rel"]["flash_attention"] > \
            CALL_REL_L2_BOUND[pol.compute_dtype]:
        raise AssertionError("cohort: flash calls disagree with the plain "
                             f"version ({calls})")
    return counts


def prefix_cohort_phase(T, serve_step, ops, sched_mod, cfg, params,
                        pol) -> dict:
    """(a)-(d) on the serve phase's bf16 weights.  Returns each run's
    launch counts."""
    t0 = time.perf_counter()
    runs = {"paged": prefix_run(ops, sched_mod, cfg, params, pol, "paged",
                                True),
            "paged_int8": prefix_run(ops, sched_mod, cfg, params, pol,
                                     "paged_int8", True),
            "unshared": prefix_run(ops, sched_mod, cfg, params, pol, "paged",
                                   False)}
    check_prefix_runs(runs)
    torch.cuda.empty_cache()
    for mode in ("paged", "paged_int8"):
        suffix_parity(T, serve_step, ops, cfg, params, pol, mode)
        torch.cuda.empty_cache()
    counts = {f"prefix_{k}": v["counts"] for k, v in runs.items()}
    counts["cohort"] = cohort_run(ops, sched_mod, cfg, params, pol)
    torch.cuda.empty_cache()
    log(f"prefix cache and cohort runs: {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# rwkv serve phases
# ---------------------------------------------------------------------------

RWKV_NEW_TOKENS = 16
# continuous mode: bucket 256, 6 requests of 64-256 prompt tokens and 4-16
# new tokens
RWKV_BUCKET, RWKV_REQUESTS = 256, 6


def rwkv_raw_run(ops, serve, cfg, params, pol) -> dict:
    """The serve CLI's raw mode (``launch/serve.py`` ``run_raw``): batch 4
    of 1024-token prompts, 16 new tokens.  Its prefill is unmasked, so
    every layer launches the wkv6 kernel once; every LayerNorm (two a
    layer and the final one) launches its kernel in the prefill and in
    each decode step.  ``run_raw`` raises on a non-finite logit row."""
    args = serve.build_parser().parse_args([
        "--arch", cfg.arch_id, "--full-width", "--mode", "raw", "--batch",
        str(BATCH), "--prompt-len", str(PREFILL_LEN), "--new-tokens",
        str(RWKV_NEW_TOKENS), "--device", DEVICE])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ids = serve.run_raw(args, cfg, pol, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    if ids.shape != (BATCH, RWKV_NEW_TOKENS):
        raise AssertionError(f"rwkv raw: generated {ids.shape}")
    if counts["wkv6"] != cfg.n_layers:
        raise AssertionError(f"rwkv raw: {counts['wkv6']} wkv6 launches, "
                             f"expected {cfg.n_layers} (one per layer)")
    norms = (2 * cfg.n_layers + 1) * RWKV_NEW_TOKENS
    if counts["layernorm"] != norms:
        raise AssertionError(f"rwkv raw: {counts['layernorm']} layernorm "
                             f"launches, expected {norms}")
    log(f"rwkv raw full width: {BATCH} x {PREFILL_LEN} prompt tokens, "
        f"{RWKV_NEW_TOKENS} new, {wall:.3f} s in all; launches {counts}")
    return counts


def rwkv_continuous_run(ops, sched_mod, cfg, params, pol) -> dict:
    """``ContinuousScheduler`` over 6 mixed-length requests.  Every slot
    prefill is masked (the exactness contract), so it runs the sequential
    scan and launches no wkv6 kernel, as in the reference."""
    rng = np.random.default_rng(SEED + 5)
    sched = sched_mod.ContinuousScheduler(
        params, cfg, pol, batch=BATCH, max_len=RWKV_BUCKET + 16,
        prefill_len=RWKV_BUCKET, device=DEVICE)
    budgets = {}
    for rid in range(RWKV_REQUESTS):
        n = int(rng.integers(64, RWKV_BUCKET + 1))
        budgets[rid] = int(rng.integers(4, 17))
        sched.submit(sched_mod.Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab_size, size=n,
                                         dtype=np.int32),
            max_new_tokens=budgets[rid]))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    done = sched.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st = sched.stats
    if len(done) != RWKV_REQUESTS or st.prefills != RWKV_REQUESTS or any(
            len(r.output) != budgets[r.rid] for r in done):
        raise AssertionError("rwkv continuous: not every request ran to its "
                             "budget and released its slot")
    if st.nonfinite_logits:
        raise AssertionError(f"rwkv continuous: {st.nonfinite_logits} "
                             "non-finite logit rows")
    if counts["wkv6"] != 0 or counts["layernorm"] <= 0:
        raise AssertionError(f"rwkv continuous: launches {counts}; the masked"
                             " prefill must not reach wkv6, the LayerNorms "
                             "must run their kernel")
    per_slot = cfg.n_layers * (2 * cfg.d_model * 4 + cfg.rwkv_n_heads
                               * cfg.rwkv_head_size ** 2 * 4)
    if st.cache_bytes != 0 or st.state_bytes != BATCH * per_slot:
        raise AssertionError(f"rwkv continuous: cache {st.cache_bytes} B, "
                             f"state {st.state_bytes} B")
    step_ms = 1e3 * st.decode_s / max(st.decode_steps - 1, 1)
    log(f"rwkv continuous: {len(done)} requests, {st.prefills} prefills "
        f"({st.prefill_tokens} prompt tokens, sequential scan), "
        f"{st.decode_steps} decode steps, {st.useful_tokens} tokens in "
        f"{st.wall_s:.3f} s ({st.tokens_per_s:.1f} tok/s), decode "
        f"{step_ms:.3f} ms/step; launches {counts}; state "
        f"{st.state_bytes / 2**20:.2f} MiB ({per_slot / 1e6:.2f} MB a slot), "
        f"KV cache 0")
    return counts


def rwkv_parity(T, ops, cfg, params, pol) -> dict:
    """The raw path's prefill (batch 4 x 1024) and 4 decode steps through
    the kernels and through the plain versions, fed the same tokens.  Each
    kernel call of the kernel path is also held against its plain version
    on that call's inputs: wkv6 at the fp32 tolerance in both dtypes (it
    computes in fp32), its absolute part scaled by the output's RMS, and
    within WKV_TOL relative L2; LayerNorm at the dtype's.  Returns the
    readings in ``path_parity``'s form."""
    rng = np.random.default_rng(SEED + 6)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(BATCH, PREFILL_LEN), dtype=np.int32)).to(
            DEVICE)
    record = {"wkv6": [], "layernorm_fwd": []}
    feed, logits = [], {}
    with held_against_plain(ops, record, {
            "wkv6": (torch.float32, True),
            "layernorm_fwd": (pol.compute_dtype, False)}):
        for impl in (None, "torch"):
            state = T.init_decode_state(cfg, BATCH, PREFILL_LEN + 8,
                                        device=DEVICE)
            lg, state = T.prefill(params, toks, cfg, pol, state=state,
                                  impl=impl)
            seq = [lg]
            for i in range(4):
                if impl is None:
                    feed.append(lg.argmax(-1, keepdim=True))
                lg, state = T.decode_step(params, feed[i], state, cfg, pol,
                                          impl=impl)
                seq.append(lg)
            logits[impl] = torch.stack(seq).float()
            del state
    a, b = logits[None], logits["torch"]
    res = {"mode": "rwkv raw", "dtype": pol.compute_dtype,
           "finite": bool(torch.isfinite(a).all()),
           "rel_l2": float((a - b).norm() / b.norm()),
           "max_abs": float((a - b).abs().max()), **call_summary(record)}
    rms = [c.rms for c in record["wkv6"]]
    log(f"path parity rwkv raw {pol.compute_dtype}: prefill + 4 decode "
        f"logits, kernels vs plain: rel L2 {res['rel_l2']:.3e} (bound "
        f"{LOGIT_REL_L2_BOUND[pol.compute_dtype]}), max abs "
        f"{res['max_abs']:.3e}, max |logit| {float(b.abs().max()):.3f}; "
        f"each kernel call vs plain on its inputs: wkv6 "
        f"{res['calls_outside']['wkv6']}/{res['calls']['wkv6']} outside "
        f"rtol {TOL[torch.float32]}, atol {TOL[torch.float32]} x output RMS "
        f"(RMS {min(rms):.3f} to {max(rms):.3f}), max err "
        f"{res['call_max_err']['wkv6']:.3e}, max rel L2 "
        f"{res['call_max_rel']['wkv6']:.3e}; layernorm "
        f"{res['calls_outside']['layernorm_fwd']}/"
        f"{res['calls']['layernorm_fwd']} outside {TOL[pol.compute_dtype]}, "
        f"max err {res['call_max_err']['layernorm_fwd']:.3e}, max rel L2 "
        f"{res['call_max_rel']['layernorm_fwd']:.3e}")
    return res


def check_rwkv_parity(res: dict) -> None:
    """``check_parity``, and each call's relative L2 error: wkv6 within
    WKV_TOL, LayerNorm within CALL_REL_L2_BOUND of the dtype."""
    check_parity(res)
    for k, bd in (("wkv6", WKV_TOL),
                  ("layernorm_fwd", CALL_REL_L2_BOUND[res["dtype"]])):
        if not res["call_max_rel"][k] <= bd:
            raise AssertionError(f"rwkv raw: a {k} call departs from the "
                                 f"plain version (rel L2 "
                                 f"{res['call_max_rel'][k]:.3e} > {bd})")


def rwkv_phases(T, ops, serve, sched_mod, get_config, make_policy) -> dict:
    """Full-width rwkv6-1.6b with seeded random weights: the raw mode and
    the continuous mode in bf16, then the kernels-vs-plain parity in bf16
    and in f32 (the same seeded weights)."""
    cfg = get_config("rwkv6-1.6b")
    pol = make_policy("bf16")
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed=SEED, dtype=pol.param_dtype,
                          device=DEVICE)
    torch.cuda.synchronize()
    log(f"rwkv6-1.6b full width: {cfg.param_count() / 1e9:.3f} B params "
        f"(bf16) made in {time.perf_counter() - t0:.1f} s")
    launches = {"rwkv_raw": rwkv_raw_run(ops, serve, cfg, params, pol),
                "rwkv_continuous": rwkv_continuous_run(ops, sched_mod, cfg,
                                                       params, pol)}
    check_rwkv_parity(rwkv_parity(T, ops, cfg, params, pol))
    del params
    torch.cuda.empty_cache()
    pol32 = make_policy("f32")
    params = T.init_model(cfg, seed=SEED, dtype=pol32.param_dtype,
                          device=DEVICE)
    check_rwkv_parity(rwkv_parity(T, ops, cfg, params, pol32))
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# training kernel phase
# ---------------------------------------------------------------------------

# BERT-large's attention shapes: phase 1 micro-batch 64 x 128, phase 2
# 32 x 512, 16 heads of 64
TRAIN_ATTN = ((64, 16, 128, 64), (32, 16, 512, 64))
TRAIN_ROWS, D_MODEL, D_FF = 64 * 128, 1024, 4096


def flash_fwd_bound(b, h, s, dh, causal=False, item=2):
    """(bound ms, by) of the flash forward as a function of its inputs: q,
    k, v read and out written once (4 activations of B H S Dh at ``item``
    bytes) plus lse (fp32), against 4 operations per (query, key) pair and
    channel (the products S and P V), only unmasked pairs when causal."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    return bound(4 * b * h * s * dh * item + b * h * s * 4, 4 * pairs * dh)


def flash_bwd_bound(b, h, s, dh, causal=False, item=2):
    """(bound ms, by) of the whole FlashAttention backward as a function of
    its inputs: the bytes of q, k, v, out and dO read and dq, dk, dv
    written once (8 activations of B H S Dh at ``item`` bytes) plus lse
    (fp32), against 10 operations per (query, key) pair and channel (the
    five products S, dP, dV, dK, dQ), only unmasked pairs when causal."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    return bound(8 * b * h * s * dh * item + b * h * s * 4, 10 * pairs * dh)


def flash_bwd_phase(ops, fa, timer):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)

    def rand(shape, dtype, model_layout=False):
        if model_layout:   # (B, S, H, Dh) memory seen as (B, H, S, Dh)
            b, h, s, d = shape
            return torch.randn((b, s, h, d), generator=gen, device=DEVICE
                               ).to(dtype).transpose(1, 2)
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    def check(tag, q, k, v, do, dtype, **kw):
        out, lse = ops.flash_attention(q, k, v, **kw)
        got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        return held(tag, got, ops.flash_attention_bwd(
            q, k, v, out, lse, do, impl="torch", **kw), dtype)

    worst_rel = collections.defaultdict(float)

    def held(tag, got, want, dtype):
        torch.cuda.synchronize()
        errs = [check_grad(f"{tag} d{n}", g, w, dtype)
                for g, w, n in zip(got, want, "qkv")]
        worst_rel[dtype] = max(worst_rel[dtype], *(r for _, r in errs))
        return max(e for e, _ in errs)

    cases = 0
    for dtype in DTYPES:
        for i, shape in enumerate(((2, 4, 256, 64), (1, 2, 200, 128),
                                   (1, 4, 130, 32))):
            for causal in (True, False):
                for window, softcap in ((0, 0.0), (64, 0.0), (0, 30.0),
                                        (64, 30.0)):
                    ml = (cases % 2 == 1)
                    q, k, v, do = (rand(shape, dtype, ml) for _ in range(4))
                    check(f"flash bwd {dtype} {shape} causal={causal} "
                          f"window={window} softcap={softcap} "
                          f"model_layout={ml}", q, k, v, do, dtype,
                          causal=causal, window=window, softcap=softcap)
                    cases += 1
    log(f"flash backward small cases: {cases} agree with the plain version "
        f"(worst relative L2 of dq, dk, dv: " + ", ".join(
            f"{dt} {r:.3e}" for dt, r in worst_rel.items()) + ")")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    entries = {}
    for phase, shape in enumerate(TRAIN_ATTN, start=1):
        b, h, s, dh = shape
        dtype = torch.bfloat16
        q, k, v, do = (rand(shape, dtype, True) for _ in range(4))
        out, lse = ops.flash_attention(q, k, v, causal=False)
        want_out, want_lse = ops.flash_attention(q, k, v, causal=False,
                                                 impl="torch")
        fwd_err = check_grad(f"flash fwd {shape} bidirectional out", out,
                             want_out, dtype)[0]
        check_grad(f"flash fwd {shape} bidirectional lse", lse, want_lse,
                   dtype)
        fwd_times = timer.times(
            lambda: ops.flash_attention(q, k, v, causal=False))
        fwd_ms = float(np.mean(fwd_times))
        fwd_lib_times = timer.times(lambda: sdpa(q, k, v))
        fwd_lib_ms = float(np.mean(fwd_lib_times))
        fwd_plain_ms = timer.ms(lambda: ops.flash_attention(
            q, k, v, causal=False, impl="torch"))
        fwd_bound = flash_fwd_bound(b, h, s, dh, item=q.element_size())
        log(f"flash forward {shape} bf16 bidirectional: max err "
            f"{fwd_err:.3e}, kernel {fwd_ms:.4f} ms ({fwd_ms / fwd_lib_ms:.2f}x"
            f" sdpa), plain {fwd_plain_ms:.4f} ms, sdpa forward "
            f"{fwd_lib_ms:.4f} ms, bound {fwd_bound[0]:.4f} ms "
            f"({fwd_bound[1]}); kernel {spread(fwd_times)}; sdpa forward "
            f"{spread(fwd_lib_times)}")
        entries[f"flash_fwd_phase{phase}"] = entry(
            f"flash_fwd_phase{phase}", "flash_fwd.cu",
            "flash_attention.py:132", fwd_err, fwd_ms, fwd_plain_ms,
            *fwd_bound, fwd_lib_ms)
        err = check(f"flash bwd {shape} bidirectional", q, k, v, do, dtype,
                    causal=False)
        # the whole backward as flash_attention_bwd launches it, then each
        # of its kernels alone on one call's buffers
        times = timer.times(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, causal=False))
        ms = float(np.mean(times))
        bufs = fa.bwd_buffers(q, s)
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        parts = {name: timer.times(lambda: fa.bwd_launch(
            part, q, k, v, out, lse, do, bufs, grads, causal=False, window=0,
            softcap=0.0)) for name, part in (
                ("pre-pass", fa.PREP), ("main pass", fa.MAIN),
                ("post-pass", fa.POST)) if part & fa.bwd_parts(bufs)}
        routes = ""
        if not fa.bwd_parts(bufs) & fa.POST:
            # the wrapper writes dq from the main pass here (one KV tile):
            # the partials route on the same inputs, held and timed
            part_bufs = bufs[:2] + (torch.empty(
                (1,) + tuple(q.shape), dtype=torch.float32, device=DEVICE),)
            route = {}
            for name, b_ in (("direct", bufs), ("partials", part_bufs)):
                route[name] = timer.times(lambda: fa.bwd_launch(
                    fa.bwd_parts(b_), q, k, v, out, lse, do, b_, grads,
                    causal=False, window=0, softcap=0.0))
            held(f"flash bwd {shape} partials route", grads,
                 ops.flash_attention_bwd(q, k, v, out, lse, do, causal=False,
                                         impl="torch"), dtype)
            routes = "; dq " + "; ".join(
                f"{n} route {float(np.mean(t)):.4f} ms ({spread(t)})"
                for n, t in route.items())
        plain_ms = timer.ms(lambda: ops.flash_attention_bwd(
            q, k, v, out, lse, do, causal=False, impl="torch"))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = sdpa(qg, kg, vg)
        lib_times = timer.times(lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), do, retain_graph=True))
        lib_ms = float(np.mean(lib_times))
        del sdpa_out
        bd = flash_bwd_bound(b, h, s, dh, item=q.element_size())
        log(f"flash {shape} bf16 bidirectional: backward max err {err:.3e}, "
            f"{ms:.4f} ms ({' + '.join(parts)}; bound {bd[0]:.4f} "
            f"ms, {bd[1]}), {ms / lib_ms:.2f}x sdpa backward {lib_ms:.4f} "
            f"ms, plain backward {plain_ms:.4f} ms; backward "
            f"{spread(times)}; sdpa backward {spread(lib_times)}; "
            + "; ".join(f"{n} {spread(t)}" for n, t in parts.items())
            + routes)
        entries[f"flash_bwd_phase{phase}"] = entry(
            f"flash_bwd_phase{phase}", "flash_bwd.cu",
            "flash_attention.py:272", err, ms, plain_ms, *bd, lib_ms)
        # determinism, bit for bit: two launches on the same inputs
        check_same_bits(f"flash bwd {shape} bf16", fa.flash_attention_bwd(
            q, k, v, out, lse, do, causal=False), fa.flash_attention_bwd(
            q, k, v, out, lse, do, causal=False))
        log(f"flash bwd {shape} bf16: two launches give the same bits "
            "(dq, dk, dv)")
        flash_f16_path(ops, fa, timer, shape, rand)
    return entries


def flash_f16_path(ops, fa, timer, shape, rand):
    """The paper's f16 at a training shape: the forward and the whole
    backward held against their plain versions (TOL and the rel L2 bound
    of f16), the backward's two launches bit for bit, both timed beside
    SDPA's f16 forward and backward."""
    dtype = torch.float16
    b, h, s, dh = shape
    q, k, v, do = (rand(shape, dtype, True) for _ in range(4))
    out, lse = ops.flash_attention(q, k, v, causal=False)
    want = ops.flash_attention(q, k, v, causal=False, impl="torch")
    torch.cuda.synchronize()
    fwd_err = max(check_grad(f"flash fwd {shape} f16 {n}", g, w, dtype)[0]
                  for g, w, n in zip((out, lse), want, ("out", "lse")))
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=False)
    want = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=False,
                                   impl="torch")
    torch.cuda.synchronize()
    errs = [check_grad(f"flash bwd {shape} f16 d{n}", g, w, dtype)
            for g, w, n in zip(got, want, "qkv")]
    check_same_bits(f"flash bwd {shape} f16", got, fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal=False))
    fwd_t = timer.times(lambda: ops.flash_attention(q, k, v, causal=False))
    bwd_t = timer.times(lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal=False))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = timer.ms(lambda: sdpa(q, k, v))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = sdpa(qg, kg, vg)
    lib_bwd = timer.ms(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do, retain_graph=True))
    del sdpa_out
    fb, bb = (flash_fwd_bound(b, h, s, dh, item=2),
              flash_bwd_bound(b, h, s, dh, item=2))
    log(f"flash {shape} f16 bidirectional: forward max err {fwd_err:.3e}, "
        f"{float(np.mean(fwd_t)):.4f} ms (sdpa {lib_fwd:.4f}, bound "
        f"{fb[0]:.4f} {fb[1]}); backward max err "
        f"{max(e for e, _ in errs):.3e}, rel L2 "
        f"{max(r for _, r in errs):.3e}, {float(np.mean(bwd_t)):.4f} ms "
        f"(sdpa backward {lib_bwd:.4f}, bound {bb[0]:.4f} {bb[1]}), two "
        f"launches the same bits; forward {spread(fwd_t)}; backward "
        f"{spread(bwd_t)}")


# LayerNorm's path shapes (rows, d): BERT-large's rows at phase 1 (64 x 128
# tokens a micro-batch) and phase 2 (32 x 512), the MLM head's rows at its
# predicted positions (64 x 20 and 32 x 80), the rwkv raw prefill (4 x 1024
# tokens of 2048) and rwkv's small calls (4 rows: a raw decode step; 256: a
# continuous slot prefill).  The backward runs the first four (training).
LN_FWD_PATH = ((8192, 1024), (16384, 1024), (1280, 1024), (2560, 1024),
               (4096, 2048), (4, 2048), (256, 2048))
LN_BWD_SHAPES = LN_FWD_PATH[:4]


def layernorm_registers(build) -> str:
    """Registers and spill store bytes of every LayerNorm kernel
    instantiation (element type, parameter type, vectors a lane) in
    ptxas's report of the last build."""
    names = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
    out = []
    for name, (regs, spill) in sorted(ptxas_registers(
            build, "layernorm", "_kernel").items()):
        m = re.search(r"(layernorm_kernel|layernorm_bwd_kernel|colsum_kernel)"
                      r"I(\w*?)EEv", name)
        if not m:
            continue
        args = []
        for t in re.findall(r"13__nv_bfloat16|6__half|S\d*_|Li\d+|f",
                            m.group(2)):
            args.append(t[2:] if t.startswith("Li") else
                        args[0] if t.startswith("S") else names[t])
        out.append(f"{m.group(1)}<{', '.join(args)}> {regs} ({spill} B "
                   "spilled)")
    return "; ".join(out)


def layernorm_phase(ops, timer):
    """``layernorm`` against its plain version: small cases in f32, bf16
    and f16 (scale and bias in x's dtype or f32, two eps), then every path
    shape in the three dtypes, each held (TOL and the per-call rel L2
    bound), launched twice for the same bits and, in bf16 and f16, timed
    beside the plain version, ``F.layer_norm`` and ``copy_`` of x (one read
    and one write of x's bytes) under both flushes."""
    from repro_torch.kernels import build
    from repro_torch.kernels import layernorm as ln
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    cases = 0
    for dtype in DTYPES:
        for shape in ((64, 128), (33, 256), (256, 1024), (2, 17, 256),
                      (7, 512), (1, 8192 if dtype != torch.float32 else 4096)):
            for pdtype in {torch.float32, dtype}:
                d = shape[-1]
                x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                sc = (1 + 0.1 * torch.randn(d, generator=gen,
                                            device=DEVICE)).to(pdtype)
                bi = (0.1 * torch.randn(d, generator=gen,
                                        device=DEVICE)).to(pdtype)
                for eps in (1e-6, 1e-12):
                    got = ops.layernorm_fwd(x, sc, bi, eps=eps)
                    want = ops.layernorm_fwd(x, sc, bi, eps=eps, impl="torch")
                    torch.cuda.synchronize()
                    for g, w, n in zip(got, want, ("y", "mean", "rstd")):
                        check_close(f"layernorm {dtype} {shape} params "
                                    f"{pdtype} eps={eps} {n}", g, w, dtype)
                    cases += 1
    log(f"layernorm small cases: {cases} agree with the plain version")
    log(f"layernorm ptxas: {layernorm_registers(build)}")
    out = None
    for dtype in DTYPES:
        for rows, d in LN_FWD_PATH:
            x = torch.randn(rows, d, generator=gen, device=DEVICE).to(dtype)
            sc = (1 + 0.1 * torch.randn(d, generator=gen,
                                        device=DEVICE)).to(dtype)
            bi = (0.1 * torch.randn(d, generator=gen, device=DEVICE)).to(dtype)
            eps = 1e-12 if d == D_MODEL else 1e-5
            run = lambda: ops.layernorm_fwd(x, sc, bi, eps=eps)
            plain = lambda: ops.layernorm_fwd(x, sc, bi, eps=eps,
                                              impl="torch")
            got, want = run(), plain()
            torch.cuda.synchronize()
            tag = f"layernorm ({rows}, {d}) {dtype}"
            err = max(check_grad(f"{tag} {n}", g, w, dtype)[0]
                      for g, w, n in zip(got, want, ("y", "mean", "rstd")))
            check_same_bits(tag, got, run())
            if dtype == torch.float32:
                continue
            buf = torch.empty_like(x)
            res = yardstick_times(
                timer, run, lambda: buf.copy_(x),
                lambda: torch.nn.functional.layer_norm(x, (d,), sc, bi, eps))
            plain_ms = timer.ms(plain)
            item = x.element_size()
            b = bound(2 * x.numel() * item + 2 * d * item + 2 * rows * 4,
                      8 * x.numel())
            ms = float(np.mean(res["times"]))
            plan = (f", rows a warp {ln.fwd_plan(rows)[1]} in "
                    f"{ln.fwd_plan(rows)[0]} blocks"
                    if hasattr(ln, "fwd_plan") else "")
            log(f"{tag}: max err {err:.3e}, two launches the same bits, "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.layer_norm "
                f"{res['write']['library']:.4f} ms, bound {b[0]:.4f} ms "
                f"({b[1]}){plan}; kernel {spread(res['times'])}; "
                + yardstick_log(res, "copy_", "F.layer_norm"))
            if (rows, d, dtype) == (TRAIN_ROWS, D_MODEL, torch.bfloat16):
                out = entry("layernorm", "layernorm.cu", "layernorm.py:40",
                            err, ms, plain_ms, *b, res["write"]["library"])
    return out


def bias_gelu_phase(ops, timer):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    cases = 0
    for dtype in DTYPES:
        for shape in ((64, 128), (100, 384), (7, 512), (1, 128), (300, 1024),
                      (1280, 1024)):
            x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
            b = torch.randn(shape[-1], generator=gen, device=DEVICE).to(dtype)
            got = ops.bias_gelu_fwd(x, b)
            want = ops.bias_gelu_fwd(x, b, impl="torch")
            torch.cuda.synchronize()
            check_close(f"bias_gelu {dtype} {shape}", got, want, dtype)
            cases += 1
    log(f"bias_gelu small cases: {cases} agree with the plain version")
    dtype = torch.bfloat16
    x = torch.randn(TRAIN_ROWS, D_FF, generator=gen, device=DEVICE).to(dtype)
    b = torch.randn(D_FF, generator=gen, device=DEVICE).to(dtype)
    err = check_close("bias_gelu path shape", ops.bias_gelu_fwd(x, b),
                      ops.bias_gelu_fwd(x, b, impl="torch"), dtype)
    times = timer.times(lambda: ops.bias_gelu_fwd(x, b))
    plain_ms = timer.ms(lambda: ops.bias_gelu_fwd(x, b, impl="torch"))
    bd = bound(2 * x.numel() * 2 + D_FF * 2, 20 * x.numel())
    ms = float(np.mean(times))
    log(f"bias_gelu ({TRAIN_ROWS}, {D_FF}) bf16: max err {err:.3e}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bd[0]:.4f} ms "
        f"({bd[1]}), no single PyTorch call; kernel {spread(times)}")
    return entry("bias_gelu", "bias_gelu.cu", "bias_gelu.py:42", err, ms,
                 plain_ms, *bd, None)


# the bias-GELU backward's path shapes: BERT-large's MLP rows (d_ff) at
# phase 1 (64 x 128 tokens a micro-batch) and phase 2 (32 x 512), and the
# MLM head's rows (d_model) at its predicted positions (64 x 20 and 32 x
# 80); the JSON line takes phase 2's
GELU_BWD_PATH = ((8192, 4096), (16384, 4096))
MLM_ROWS = (1280, 2560)


def held_bwd(tag, got, want, dtype, worst):
    """Each output of a row backward within TOL and the rel L2 bound of
    ``dtype``; returns the max abs error and records the worst rel L2."""
    torch.cuda.synchronize()
    errs = [check_grad(f"{tag} output {i}", g, w, dtype)
            for i, (g, w) in enumerate(zip(got, want))]
    worst[dtype] = max(worst[dtype], *(r for _, r in errs))
    return max(e for e, _ in errs)


def layernorm_bwd_phase(ops, timer):
    """``layernorm_bwd`` against its plain version: the forward's small
    shapes in f32, bf16 and f16 with scale in x's dtype or f32, then the
    path shapes in the three dtypes, each held, launched twice for the same
    bits and, in bf16 and f16, timed beside the plain version,
    ``native_layer_norm_backward`` on the same saved mean and rstd and
    ``torch.add(x, dy, out=)`` (two reads and one write of x's bytes: the
    kernel's) under both flushes, with its launches timed apart from a
    profiler trace."""
    from repro_torch.kernels import layernorm as ln
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=DEVICE)

    def inputs(shape, dtype, pdtype):
        d = shape[-1]
        x = randn(*shape).to(dtype)
        sc = (1 + 0.1 * randn(d)).to(pdtype)
        bi = (0.1 * randn(d)).to(pdtype)
        _, mean, rstd = ops.layernorm_fwd(x, sc, bi, eps=1e-12)
        return randn(*shape).to(dtype), x, sc, bi, mean, rstd

    cases, worst = 0, collections.defaultdict(float)
    for dtype in DTYPES:
        # rows of 2048 in every dtype: f32's take the 16-vector instance
        # (rwkv6-1.6b's d_model; its training shape, 4096 rows, in f32)
        for shape in ((64, 128), (33, 256), (256, 1024), (2, 17, 256),
                      (7, 512), (20, 2048)) + (
                          ((4096, 2048),) if dtype == torch.float32 else ()):
            for pdtype in {torch.float32, dtype}:
                dy, x, sc, _, mean, rstd = inputs(shape, dtype, pdtype)
                got = ops.layernorm_bwd(dy, x, sc, mean, rstd)
                held_bwd(f"layernorm_bwd {dtype} {shape} scale {pdtype}",
                         got, ops.layernorm_bwd(dy, x, sc, mean, rstd,
                                                impl="torch"), dtype, worst)
                cases += 1
    log(f"layernorm_bwd small cases: {cases} agree with the plain version "
        "(worst rel L2 of dx, dscale, dbias: " + ", ".join(
            f"{dt} {r:.3e}" for dt, r in worst.items()) + ")")
    out = None
    lib = torch.ops.aten.native_layer_norm_backward
    for dtype in DTYPES:
        for rows, d in LN_BWD_SHAPES:
            dy, x, sc, bi, mean, rstd = inputs((rows, d), dtype, dtype)
            args = (dy, x, sc, mean, rstd)
            got = ops.layernorm_bwd(*args)
            tag = f"layernorm_bwd ({rows}, {d}) {dtype}"
            err = held_bwd(tag, got, ops.layernorm_bwd(*args, impl="torch"),
                           dtype, worst)
            check_same_bits(tag, got, ops.layernorm_bwd(*args))
            if dtype == torch.float32:
                continue
            buf = torch.empty_like(x)
            run = lambda: ops.layernorm_bwd(*args)
            res = yardstick_times(
                timer, run, lambda: torch.add(x, dy, out=buf),
                lambda: lib(dy, x, [d], mean.view(rows, 1),
                            rstd.view(rows, 1), sc, bi, [True, True, True]))
            parts = device_split(timer, run, ("layernorm_bwd", "colsum"))
            plain_ms = timer.ms(lambda: ops.layernorm_bwd(*args,
                                                          impl="torch"))
            # x and dy read, dx written, scale read, mean and rstd read,
            # dscale and dbias written; 13 fp32 operations an element
            item = x.element_size()
            nbytes = 3 * x.numel() * item + 3 * d * item + 2 * rows * 4
            bd = bound(nbytes, 13 * x.numel(), torch.float32)
            ms = float(np.mean(res["times"]))
            log(f"{tag}: max err {err:.3e}, two launches the same bits, "
                f"kernel {ms:.4f} ms (launches apart, profiler: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in parts.items()) +
                f"), plain {plain_ms:.4f} ms, native_layer_norm_backward "
                f"{res['write']['library']:.4f} ms, bound {bd[0]:.4f} ms "
                f"({bd[1]}), tiles {ln.bwd_tiles(rows)}; kernel "
                f"{spread(res['times'])}; "
                + yardstick_log(res, "torch.add", "native_layer_norm_bwd"))
            if (rows, d, dtype) == (2 * TRAIN_ROWS, D_MODEL, torch.bfloat16):
                out = entry("layernorm_bwd", "layernorm.cu",
                            "layernorm.py:40", err, ms, plain_ms, *bd,
                            res["write"]["library"])
    return out


def bias_gelu_bwd_phase(ops, timer):
    """``bias_gelu_bwd`` against its plain version: the forward's small
    shapes in f32, bf16 and f16, then the path shapes (the MLP's and the
    MLM head's), each held and launched twice for the same bits, the MLP's
    timed beside the plain version (no single PyTorch call computes it)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=DEVICE)
    cases, worst = 0, collections.defaultdict(float)
    for dtype in DTYPES:
        for shape in ((64, 128), (100, 384), (7, 512), (1, 128), (300, 1024),
                      (2, 65, 256)):
            dy, x, b = (randn(*shape).to(dtype), randn(*shape).to(dtype),
                        randn(shape[-1]).to(dtype))
            held_bwd(f"bias_gelu_bwd {dtype} {shape}",
                     ops.bias_gelu_bwd(dy, x, b),
                     ops.bias_gelu_bwd(dy, x, b, impl="torch"), dtype, worst)
            cases += 1
    log(f"bias_gelu_bwd small cases: {cases} agree with the plain version "
        "(worst rel L2 of dx, db: " + ", ".join(
            f"{dt} {r:.3e}" for dt, r in worst.items()) + ")")
    out = None
    for dtype in (torch.float16, torch.bfloat16):
        for rows, d in ((r, D_MODEL) for r in MLM_ROWS):
            dy, x, b = (randn(rows, d).to(dtype), randn(rows, d).to(dtype),
                        randn(d).to(dtype))
            got = ops.bias_gelu_bwd(dy, x, b)
            held_bwd(f"bias_gelu_bwd ({rows}, {d}) {dtype}", got,
                     ops.bias_gelu_bwd(dy, x, b, impl="torch"), dtype, worst)
            check_same_bits(f"bias_gelu_bwd ({rows}, {d}) {dtype}", got,
                            ops.bias_gelu_bwd(dy, x, b))
        for rows, d in GELU_BWD_PATH:
            dy, x, b = (randn(rows, d).to(dtype), randn(rows, d).to(dtype),
                        randn(d).to(dtype))
            got = ops.bias_gelu_bwd(dy, x, b)
            err = held_bwd(f"bias_gelu_bwd ({rows}, {d}) {dtype}", got,
                           ops.bias_gelu_bwd(dy, x, b, impl="torch"), dtype,
                           worst)
            check_same_bits(f"bias_gelu_bwd ({rows}, {d}) {dtype}", got,
                            ops.bias_gelu_bwd(dy, x, b))
            times = timer.times(lambda: ops.bias_gelu_bwd(dy, x, b))
            plain_ms = timer.ms(lambda: ops.bias_gelu_bwd(dy, x, b,
                                                          impl="torch"))
            # x and dy read, dx written, b read and db written; ~20 fp32
            # operations and one tanh an element
            nbytes = 3 * x.numel() * 2 + 2 * d * 2
            bd = bound(nbytes, 21 * x.numel(), torch.float32)
            ms = float(np.mean(times))
            log(f"bias_gelu_bwd ({rows}, {d}) {dtype}: max err {err:.3e}, "
                f"two launches the same bits, kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), no "
                f"single PyTorch call; kernel {spread(times)}")
            out = entry("bias_gelu_bwd", "bias_gelu.cu", "bias_gelu.py:42",
                        err, ms, plain_ms, *bd, None)
    return out


def lamb_phase(ops, timer, n_path, tag="lamb_moments"):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)

    def state(n):
        w, g = (torch.randn(n, generator=gen, device=DEVICE)
                for _ in range(2))
        m = 0.1 * torch.randn(n, generator=gen, device=DEVICE)
        v = (0.1 * torch.randn(n, generator=gen, device=DEVICE)).abs()
        return w, g, m, v

    kw = dict(b1=0.9, b2=0.999, eps=1e-6, wd=0.01)
    for n in (128, 1000, 65553):
        for step in (1, 7):
            args = state(n)
            got = ops.lamb_moments(*args, step=step, **kw)
            want = ops.lamb_moments(*args, step=step, impl="torch", **kw)
            torch.cuda.synchronize()
            for g, w, name in zip(got, want, ("m", "v", "update")):
                check_close(f"lamb n={n} step={step} {name}", g, w,
                            torch.float32)
    log("lamb small cases: 6 agree with the plain version")
    args = state(n_path)
    got = ops.lamb_moments(*args, step=3, **kw)
    want = ops.lamb_moments(*args, step=3, impl="torch", **kw)
    torch.cuda.synchronize()
    err = max(check_close(f"lamb n={n_path} {name}", g, w, torch.float32)
              for g, w, name in zip(got, want, ("m", "v", "update")))
    del got, want
    times = timer.times(lambda: ops.lamb_moments(*args, step=3, **kw))
    plain_ms = timer.ms(lambda: ops.lamb_moments(*args, step=3,
                                                 impl="torch", **kw))
    bd = bound(28 * n_path, 15 * n_path, torch.float32)
    ms = float(np.mean(times))
    log(f"lamb n={n_path} (the largest leaf group): max err {err:.3e}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bd[0]:.4f} ms "
        f"({bd[1]}), no single PyTorch call; kernel {spread(times)}")
    return entry(tag, "lamb_update.cu", "lamb_update.py:49", err, ms,
                 plain_ms, *bd, None)


# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------

TRAIN_KERNELS = ("flash_fwd", "flash_bwd_prep", "flash_bwd", "flash_bwd_post",
                 "layernorm", "layernorm_bwd", "bias_gelu", "bias_gelu_bwd",
                 "lamb_moments")
TRAIN_ARGS = ["--full-width", "--steps", "5", "--batch", "128", "--accum",
              "2", "--device", DEVICE, "--seed", str(SEED)]
# kernel path vs plain path of one training step from the same state on
# the same batch, per dtype: |loss difference| / |loss|, the largest
# relative L2 difference of a gradient group, and the relative L2
# difference of the master weights' update (new - old).  In f32 the two
# paths differ only by summation order.
#
# bf16, measured on the H100 (the seeds fix the data, so the readings
# repeat): loss 1.3e-6, worst gradient group 5.0e-2 (pooler.w), update
# 0.19.  The update is LAMB's first step, m / sqrt(v) = g / |g| per
# element: wherever a bf16 gradient sits near 0 the two paths' signs
# differ, so the update moves far more than the gradients.  The bf16
# gradient and update bounds are about twice the readings, the loss bound
# 1e-4; they catch gross faults only.  The tight checks of the bf16
# kernels are the per-call ones below, and the f32 step holds the path.
#
# f16 (the paper's setting, with the dynamic loss scale at 2**15), measured
# on the H100: loss 9.3e-7, worst gradient group 4.8e-3 (pooler.w), update
# 5.0e-2 -- f16's 3 more mantissa bits than bf16's show as ten times
# smaller gradient differences and fewer sign flips in LAMB's first step.
# Its bounds are about twice the readings (the loss bound f32's).  Both
# paths must also take the same step: the same finite flag, skip and loss
# scale.
TRAIN_BOUND = {torch.float32: {"loss": 1e-5, "grad": 1e-3, "update": 1e-3},
               torch.bfloat16: {"loss": 1e-4, "grad": 1e-1, "update": 0.4},
               torch.float16: {"loss": 1e-5, "grad": 1e-2, "update": 0.1}}
HELD = ("flash_attention", "flash_attention_bwd", "layernorm_fwd",
        "layernorm_bwd", "bias_gelu_fwd", "bias_gelu_bwd", "lamb_moments")
# the backward kernels, held call by call in a phase-2 gradient step
BWD_HELD = ("flash_attention_bwd", "layernorm_bwd", "bias_gelu_bwd")


def train_run(ops, pretrain_bert, workdir, precision):
    """``pretrain_bert`` at full width in ``precision``.  Returns the
    launch counts, among them the forward's and the backward main pass's
    launches by sequence length (``flash_fwd_s128``, ``flash_fwd_s512``,
    ``flash_bwd_s128``, ``flash_bwd_s512``), which must add up to each
    one's count, and ((phase, step), loss) of every step.  Every loss must
    be finite; in f16 a step may be skipped (an overflow under the loss
    scale, which then backs off), in bf16 none."""
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    cfg, state, history = pretrain_bert.run(
        TRAIN_ARGS + ["--precision", precision, "--workdir", str(workdir)])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for r in history:
        log(f"train {precision} {r['phase']} step {r['step']}: loss "
            f"{r['loss']:.4f} (mlm {r['mlm_loss']:.4f}, nsp "
            f"{r['nsp_loss']:.4f}), grad norm {r['grad_norm']:.4f}, lr "
            f"{r['lr']:.3g}, loss scale {r['loss_scale']:g}, skipped "
            f"{bool(r['skipped'])}, {r['ms']:.1f} ms")
    if [r["phase"] for r in history] != ["phase1"] * 4 + ["phase2"]:
        raise AssertionError("train: expected 4 phase-1 steps and 1 phase-2 "
                             "step")
    bad = [r for r in history if not np.isfinite(r["loss"])
           or (r["skipped"] and precision != "f16")]
    if bad or all(r["skipped"] for r in history):
        raise AssertionError(f"train {precision}: non-finite or skipped "
                             f"steps {bad or history}")
    for k in TRAIN_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"train {precision}: kernel {k} never "
                                 "launched")
    for kind in ("fwd", "bwd"):
        by_seq = {k: n for k, n in counts.items()
                  if k.startswith(f"flash_{kind}_s")}
        if sum(by_seq.values()) != counts[f"flash_{kind}"] or set(by_seq) != {
                f"flash_{kind}_s{s}" for _, _, s, _ in TRAIN_ATTN}:
            raise AssertionError(f"train: flash_{kind} launches by length "
                                 f"{by_seq} vs {counts[f'flash_{kind}']} in "
                                 "all")
    log(f"train bert-large full width {precision}: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, launches {counts}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ckpts = sorted((workdir / "ckpt").glob("*/ckpt_*.npz"))
    if [p.parent.name for p in ckpts] != ["phase1", "phase2"]:
        raise AssertionError(f"train {precision}: expected the final "
                             f"checkpoint of each phase, found {ckpts}")
    log(f"train {precision}: checkpoints "
        + ", ".join(f"{p.parent.name}/{p.name} {p.stat().st_size} bytes"
                    for p in ckpts) + " (removed)")
    shutil.rmtree(workdir / "ckpt")
    return counts, [((r["phase"], r["step"]), r["loss"]) for r in history]


def train_parity(ops, api, ts, TrainConfig, ShardedLoader, make_policy,
                 cfg, workdir, precision) -> dict:
    """One step from a fresh state on the first phase-1 batch, through the
    kernels (every call held against its plain version on its inputs) and
    through the plain versions."""
    pol = make_policy(precision)
    tcfg = TrainConfig(precision=precision, accum_steps=2, optimizer="lamb",
                       learning_rate=1e-4 * 20, total_steps=4,
                       warmup_steps=2)
    batch = api.to_device(next(ShardedLoader(
        str(workdir / "phase1"), worker=0, n_workers=1, batch=128,
        seed=SEED)), DEVICE)
    params = api.init_params(cfg, seed=SEED + 1, device=DEVICE)
    record = {name: [] for name in HELD}
    got = {}
    for impl in (None, "torch"):
        state = ts.init_train_state(params, pol, tcfg, cfg=cfg)
        old = {p: t.clone() for p, t in state.opt.master.items()}
        with (held_against_plain(ops, record, {k: (None, False)
                                               for k in HELD})
              if impl is None
              else contextlib.nullcontext()):
            loss, grads, _ = ts.step_gradients(state, batch, cfg=cfg,
                                               tcfg=tcfg, policy=pol,
                                               impl=impl)
            state, metrics = ts.train_step_fn(state, batch, cfg=cfg,
                                              tcfg=tcfg, policy=pol,
                                              impl=impl)
        got[impl] = (float(loss), grads, {p: state.opt.master[p] - old[p]
                                          for p in old},
                     {k: metrics[k] for k in ("skipped", "loss_scale")})
        del state, old
        torch.cuda.empty_cache()
    del params
    (lk, gk, uk, mk), (lp, gp, up, mp) = got[None], got["torch"]
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp(min=1e-30))
    grad_rel = {p: rel(gk[p], gp[p]) for p in gp}
    worst = max(grad_rel, key=grad_rel.get)
    res = {"dtype": pol.compute_dtype, "loss_rel": abs(lk - lp) / abs(lp),
           "loss": (lk, lp), "grad_rel": grad_rel[worst],
           "grad_worst": ".".join(worst),
           "update_rel": max(rel(uk[p], up[p]) for p in up),
           "finite": all(bool(torch.isfinite(g).all()) for g in gk.values()),
           "same_step": mk == mp, "step": mk, **call_summary(record)}
    log(f"train parity {precision}: loss {lk:.6f} (kernels) vs {lp:.6f} "
        f"(plain), rel {res['loss_rel']:.3e}; worst gradient group "
        f"{res['grad_worst']} rel L2 {res['grad_rel']:.3e}; master update "
        f"rel L2 {res['update_rel']:.3e} (bounds "
        f"{TRAIN_BOUND[pol.compute_dtype]}); step {mk} (kernels) vs {mp} "
        f"(plain); each kernel call vs plain on "
        f"its inputs: " + ", ".join(
            f"{k} {res['calls_outside'][k]}/{res['calls'][k]} outside, max "
            f"err {res['call_max_err'][k]:.3e}, max rel L2 "
            f"{res['call_max_rel'][k]:.3e}" for k in record))
    return res


def bwd_hold_inputs(api, ts, TrainConfig, InputShape, make_policy, cfg):
    """(state, batch, tcfg, policy) of ``bwd_hold``: a fresh bf16 LAMB
    state of ``cfg`` and a seeded phase-2 batch of 8 x 512 tokens, four KV
    tiles of 128 keys, so the backward runs its dQ accumulator and
    post-pass, as every phase-2 step does."""
    pol = make_policy("bf16")
    tcfg = TrainConfig(precision="bf16", accum_steps=1, optimizer="lamb")
    state = ts.init_train_state(
        api.init_params(cfg, seed=SEED, device=DEVICE), pol, tcfg, cfg=cfg)
    batch = api.to_device(api.make_synth_batch(
        SEED, cfg, InputShape("phase2", 512, 8, "train")), DEVICE)
    return state, batch, tcfg, pol


def bwd_hold(ops, ts, cfg, state, batch, tcfg, pol,
             held=BWD_HELD) -> dict:
    """One gradient step with every call of a kernel of ``held`` (by
    default the backward kernels, BWD_HELD) held against the plain version
    on that call's inputs (elementwise TOL and relative L2
    CALL_REL_L2_BOUND); ``check_calls`` judges the readings."""
    record = {k: [] for k in held}
    with held_against_plain(ops, record, {k: (None, False)
                                          for k in held}):
        ts.step_gradients(state, batch, cfg=cfg, tcfg=tcfg, policy=pol)
        torch.cuda.synchronize()
    res = {"dtype": pol.compute_dtype, **call_summary(record)}
    log(f"phase-2 backward hold {pol.compute_dtype}: " + ", ".join(
        f"{k} {res['calls_outside'][k]}/{res['calls'][k]} calls outside, "
        f"max err {res['call_max_err'][k]:.3e}, max rel L2 "
        f"{res['call_max_rel'][k]:.3e}" for k in held))
    return res


def step_determinism(ts, cfg, state, batch, tcfg, pol) -> dict:
    """Two gradient steps through the kernels from one state on one batch:
    which gradient groups differ in any bit, and which ops of the step
    PyTorch itself names non-deterministic (a third step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, its
    warnings collected).  The kernels' own holds are the bit-for-bit
    checks of the kernel phases; this reading is logged, not judged."""
    grads = []
    for _ in range(2):
        grads.append(ts.step_gradients(state, batch, cfg=cfg, tcfg=tcfg,
                                       policy=pol)[1])
        torch.cuda.synchronize()
    differ = [".".join(map(str, p)) for p in grads[0]
              if not same_bits(grads[0][p], grads[1][p])]
    del grads
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            ts.step_gradients(state, batch, cfg=cfg, tcfg=tcfg, policy=pol)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split(" does not have")[0]
                    for w in caught if "deterministic" in str(w.message)})
    log(f"whole-step determinism {pol.compute_dtype}: two phase-2 gradient "
        f"steps from one state, {len(differ)} gradient groups differ "
        f"({differ}); ops PyTorch names non-deterministic in the step: "
        f"{named}")
    return {"differ": differ, "named": named}


def check_calls(tag, res: dict) -> None:
    """Every kernel of ``res`` called, each call within the elementwise
    tolerance and the relative L2 bound of the dtype."""
    for k, n in res["calls"].items():
        if n == 0:
            raise AssertionError(f"{tag}: {k} was never called")
        if res["calls_outside"][k]:
            raise AssertionError(f"{tag}: {res['calls_outside'][k]} of {n} "
                                 f"{k} calls disagree with the plain version")
        if not res["call_max_rel"][k] <= CALL_REL_L2_BOUND[res["dtype"]]:
            raise AssertionError(f"{tag}: a {k} call departs from the plain "
                                 f"version (rel L2 {res['call_max_rel'][k]:.3e})")


def check_train_parity(res: dict, bounds=TRAIN_BOUND,
                       name: str = "train") -> None:
    tag, bd = f"{name} parity {res['dtype']}", bounds[res["dtype"]]
    if not res["finite"]:
        raise AssertionError(f"{tag}: non-finite kernel-path gradients")
    if not res["same_step"]:
        raise AssertionError(f"{tag}: the kernel path took another step than "
                             f"the plain path (skip, loss scale: "
                             f"{res['step']})")
    check_calls(tag, res)
    for key, name in (("loss_rel", "loss"), ("grad_rel", "grad"),
                      ("update_rel", "update")):
        if not res[key] <= bd[name]:
            raise AssertionError(f"{tag}: {name} departs from the plain path "
                                 f"({res[key]:.3e} > {bd[name]})")


# ---------------------------------------------------------------------------
# resume phase
# ---------------------------------------------------------------------------

# 12 phase-1 steps (checkpoints at 10 and, the phase's last, 12) and 1
# phase-2 step, every step's loss logged.  The crash after step 11 leaves
# phase 1's checkpoint 10; the resume replays 11 and 12, then runs phase 2.
# crash_at counts the steps of each train_loop call (a phase), and phase 2
# has one step, so it fires in phase 1 only.
RESUME_STEPS, RESUME_CRASH, RESUME_FROM = 13, 11, 10
RESUME_ARGS = ["--full-width", "--batch", "128", "--accum", "2", "--seed",
               str(SEED), "--steps", str(RESUME_STEPS)]
CKPT_LINE = re.compile(r"checkpoint step (\d+) (saved in|restored from) "
                       r"(\S+): (\d+) bytes in ([\d.]+) s")


def _port_env() -> dict:
    """The environment of a port process started from here."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    env.pop("REPRO_FAULTS", None)
    return env


def pretrain_cli(workdir: Path, loss_log: Path, faults: str = "",
                 resume: bool = False) -> dict:
    """One process of ``python -m repro_torch.launch.pretrain_bert``
    (bf16 on the card) with RESUME_ARGS.  Returns its exit code, output,
    seconds, checkpoint saves and restores (step, "saved in" or "restored
    from", directory, bytes, seconds) and, when it ran to its end, its
    kernel launches."""
    env = _port_env()
    if faults:
        env["REPRO_FAULTS"] = faults
    cmd = [sys.executable, "-m", "repro_torch.launch.pretrain_bert",
           *RESUME_ARGS, "--workdir", str(workdir), "--loss-log",
           str(loss_log)] + (["--resume"] if resume else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    out = proc.stdout + proc.stderr
    launches = re.search(r"kernel launches (\{.*\})", out)
    return {"rc": proc.returncode, "out": out,
            "s": time.perf_counter() - t0,
            "ckpt": [(int(m[0]), m[1], Path(m[2]).name, int(m[3]),
                      float(m[4])) for m in CKPT_LINE.findall(out)],
            "launches": json.loads(launches[1]) if launches else None}


def expect_run(tag: str, run: dict, rc: int) -> None:
    """The exit code ``rc``, and every training kernel launched in a run
    that ended."""
    if run["rc"] != rc:
        raise AssertionError(f"resume: the {tag} run exited {run['rc']}, "
                             f"not {rc}:\n{run['out'][-4000:]}")
    if rc == 0:
        missed = [k for k in TRAIN_KERNELS
                  if not (run["launches"] or {}).get(k, 0) > 0]
        if missed:
            raise AssertionError(f"resume: the {tag} run never launched "
                                 f"{missed}")
    log(f"resume: {tag} run exit {run['rc']} in {run['s']:.1f} s; "
        "checkpoints " + "; ".join(
            f"{d} step {st} {what.split()[0]} {b} bytes in {sec:.3f} s"
            for st, what, d, b, sec in run["ckpt"]))


def read_losses(path: Path) -> list:
    """((phase, step), loss) for each line of a ``--loss-log`` file."""
    return [((r["phase"], r["step"]), r["loss"]) for r in
            map(json.loads, path.read_text().splitlines())]


def resume_phase(latest_step) -> dict:
    """Crash -> resume of the real CLI at full-width bert-large in bf16,
    three processes: an uninterrupted run; a run with
    ``REPRO_FAULTS=crash_at=RESUME_CRASH``, which must exit 43 with phase
    1's newest valid checkpoint at RESUME_FROM; and a ``--resume`` run in
    the crashed run's workdir.  Every loss of both faulted runs must have
    the uninterrupted run's float32 bits.  Each workdir is removed once
    checked, so one run's checkpoints are on disk at a time."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        tmp = Path(tmp)
        whole = pretrain_cli(tmp / "whole", tmp / "whole.jsonl")
        expect_run("uninterrupted", whole, 0)
        ref = dict(read_losses(tmp / "whole.jsonl"))
        want = [("phase1", i) for i in range(1, RESUME_STEPS)] + [
            ("phase2", 1)]
        if sorted(ref) != want:
            raise AssertionError(f"resume: uninterrupted steps {sorted(ref)}")
        shutil.rmtree(tmp / "whole")

        crash = pretrain_cli(tmp / "run", tmp / "run.jsonl",
                             faults=f"crash_at={RESUME_CRASH}")
        expect_run("crash", crash, 43)
        crashed = read_losses(tmp / "run.jsonl")
        if [k for k, _ in crashed] != want[:RESUME_CRASH]:
            raise AssertionError(f"resume: the crashed run logged {crashed}")
        t0 = time.perf_counter()
        last = latest_step(str(tmp / "run" / "ckpt" / "phase1"))
        t_latest = time.perf_counter() - t0
        if last != RESUME_FROM:
            raise AssertionError(f"resume: newest valid checkpoint {last}, "
                                 f"expected {RESUME_FROM}")

        resumed = pretrain_cli(tmp / "run", tmp / "run.jsonl", resume=True)
        expect_run("resumed", resumed, 0)
        if f"resumed from checkpoint step {RESUME_FROM} in" not in \
                resumed["out"]:
            raise AssertionError("resume: the resumed run did not start "
                                 f"from step {RESUME_FROM}")
        replayed = read_losses(tmp / "run.jsonl")[len(crashed):]
        if [k for k, _ in replayed] != want[RESUME_FROM:]:
            raise AssertionError(f"resume: the resumed run logged {replayed}")
        differ = [(k, loss.hex(), ref[k].hex())
                  for k, loss in crashed + replayed
                  if loss.hex() != ref[k].hex()]
        shutil.rmtree(tmp / "run")
    for k, loss in crashed + replayed:
        log(f"resume: {k[0]} step {k[1]} loss {loss.hex()} ({loss:.6f}), "
            f"uninterrupted {ref[k].hex()}")
    saves = [c for r in (whole, crash, resumed) for c in r["ckpt"]
             if c[1] == "saved in"]
    restores = [c for c in resumed["ckpt"] if c[1] == "restored from"]
    res = {"steps_compared": len(crashed) + len(replayed),
           "replayed": [k for k, _ in replayed], "differ": differ,
           "bytes": saves[0][3], "save_s": [c[4] for c in saves],
           "restore_s": [c[4] for c in restores], "latest_step_s": t_latest,
           "run_s": [whole["s"], crash["s"], resumed["s"]],
           "phase_s": time.perf_counter() - t_phase}
    log(f"resume on {nvidia_smi()}: checkpoint {res['bytes']} bytes "
        f"({res['bytes'] / 1e9:.3f} GB); {len(saves)} saves, "
        + ", ".join(f"{x:.3f}" for x in res["save_s"]) + " s; restore "
        + ", ".join(f"{x:.3f}" for x in res["restore_s"])
        + f" s (validation included); latest_step {t_latest:.3f} s; runs "
        + ", ".join(f"{x:.1f}" for x in res["run_s"])
        + f" s; phase {res['phase_s']:.1f} s; {res['steps_compared']} "
        f"losses compared bit for bit (replayed {res['replayed']}), "
        f"{len(differ)} differ")
    if differ:
        raise AssertionError(f"resume: losses differ from the uninterrupted "
                             f"run's bits: {differ}")
    return res


# ---------------------------------------------------------------------------
# data-parallel phase
# ---------------------------------------------------------------------------

# (b) the four strategies and (d) the compressed and overlapped cases, in
# one dp_check run (each serial case before its overlapped twin)
DP_CASES = ("psum", "ring", "hierarchical", "bucketed", "hierarchical+fp16",
            "psum+int8", "bucketed+overlap", "psum+int8+overlap")

# a phase-1 step (one 128-key tile) launches no flash backward post-pass
DP_KERNELS = tuple(k for k in TRAIN_KERNELS if k != "flash_bwd_post")
# (b)-(d) at DP_LAYERS of bert-large's 24 layers, full width: at full
# depth (c)'s three runs wrote checkpoints of 5.4 GB (~231 s of the phase)
# and dp_check's four ranks each exchanged 2.0 GB a case (~180 s)
DP_LAYERS = 4
# (c): int8 + overlap + the timing breakdown at world 1 on NCCL, step 8's
# arguments at DP_LAYERS; a checkpoint at phase-1 step 3 (holding 3
# steps' residual) and the phase's end, 4; the crash after step 4 leaves
# step 3's
DP_COMP_FLAGS = ["--dp", "--strategy", "psum", "--grad-compression", "int8",
                 "--overlap", "--timing-breakdown", "--ckpt-every", "3",
                 "--precision", "bf16", "--layers", str(DP_LAYERS)]
DP_CHECK_ARGS = ["--full-width", "--layers", str(DP_LAYERS), "--world", "4",
                 "--pods", "2", "--backend", "gloo", "--share-device",
                 "--cases", *DP_CASES]
DP_CRASH, DP_FROM = 4, 3
# (a) the serial exchange and (a') the uncompressed overlapped drain at
# world 1 on NCCL, each held to the in-process run's bits
DP_WORLD1 = (("(a)", ["--dp", "--strategy", "psum", "--precision", "bf16"]),
             ("(a')", ["--dp", "--strategy", "bucketed", "--overlap",
                       "--precision", "bf16"]))
TIMING_LINE = re.compile(r"(phase\d) step (\d+): .*; compute_s ([\d.]+), "
                         r"exchange_s ([\d.]+), overlap_frac ([\w.]+)")
QUANT_LINE = re.compile(r"(phase\d) step (\d+): .*; quantise_s ([\d.]+), "
                        r"dequantise_s ([\d.]+)")


def dp_torchrun(workdir: Path, loss_log: Path, extra, faults: str = "",
                timeout: int = 600) -> dict:
    """One torchrun world-1 process of ``pretrain_bert`` with TRAIN_ARGS
    and ``extra``: its exit code, output, seconds and its training loops'
    kernel launches (the timing calibration's twins left out)."""
    env = _port_env()
    if faults:
        env["REPRO_FAULTS"] = faults
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.pretrain_bert",
           *TRAIN_ARGS, *extra, "--workdir", str(workdir), "--loss-log",
           str(loss_log)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    out = proc.stdout + proc.stderr
    launches = re.search(r"kernel launches (\{.*\})", out)
    return {"rc": proc.returncode, "out": out,
            "s": time.perf_counter() - t0,
            "ckpt": [(int(m[0]), m[1], Path(m[2]).name, int(m[3]),
                      float(m[4])) for m in CKPT_LINE.findall(out)],
            "launches": json.loads(launches[1]) if launches else None}


def dp_compressed_cli(tmp: Path) -> dict:
    """(c): ``--dp --grad-compression int8 --overlap --timing-breakdown``
    at world 1 on NCCL through torchrun, full width in bf16: an
    uninterrupted run, one crashed after phase-1 step DP_CRASH, and the
    crashed one resumed from step DP_FROM.  Every loss of the faulted runs
    must have the uninterrupted run's bits, every training kernel must
    launch in the runs that ended, the checkpoint must hold the residual
    group, and the runs must log compute_s, exchange_s and overlap_frac."""
    t_part = time.perf_counter()

    def ran(tag, rc, run):
        """The run's exit (torchrun exits 1 when its rank fails, and names
        the rank's code), NCCL on the card, and every training kernel
        launched in a run that ended."""
        if (run["rc"] == 0) != (rc == 0) or (rc and not re.search(
                rf"exitcode\s*:\s*{rc}", run["out"])):
            raise AssertionError(f"dp (c): the {tag} run exited "
                                 f"{run['rc']}, its rank not {rc}:\n"
                                 f"{run['out'][-4000:]}")
        if "rank 0 of 1 (pod 0 of 1), nccl on cuda:0" not in run["out"]:
            raise AssertionError(f"dp (c): the {tag} run did not run on "
                                 "NCCL on cuda:0")
        missed = [k for k in TRAIN_KERNELS
                  if rc == 0 and not (run["launches"] or {}).get(k, 0) > 0]
        if missed:
            raise AssertionError(f"dp (c): the {tag} run never launched "
                                 f"{missed}")
        return run

    runs = {}
    # the uninterrupted and the crashed run at the same time (two
    # processes on the card): nothing of theirs is judged by its time
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        whole = pool.submit(dp_torchrun, tmp / "whole", tmp / "whole.jsonl",
                            DP_COMP_FLAGS)
        crash = pool.submit(dp_torchrun, tmp / "run", tmp / "run.jsonl",
                            DP_COMP_FLAGS, faults=f"crash_at={DP_CRASH}")
        runs["whole"] = ran("whole", 0, whole.result())
        runs["crash"] = ran("crash", 43, crash.result())
    shutil.rmtree(tmp / "whole" / "ckpt", ignore_errors=True)
    man = json.loads((tmp / "run" / "ckpt" / "phase1" /
                      f"ckpt_{DP_FROM:08d}.json").read_text())
    npz = tmp / "run" / "ckpt" / "phase1" / f"ckpt_{DP_FROM:08d}.npz"
    err = [(n, sh) for n, sh in zip(man["names"], man["shapes"])
           if n.startswith("err/")]
    with np.load(npz) as z:
        err_max = max(float(np.abs(z[f"a{man['names'].index(n):06d}"]).max())
                      for n, _ in err)
    ckpt = {"bytes": npz.stat().st_size, "leaves": len(man["names"]),
            "residual_leaves": len(err),
            "residual_bytes": 4 * sum(int(np.prod(sh)) for _, sh in err),
            "residual_max": err_max}
    runs["resumed"] = ran("resumed", 0, dp_torchrun(
        tmp / "run", tmp / "run.jsonl", DP_COMP_FLAGS + ["--resume"]))
    if f"resumed from checkpoint step {DP_FROM} in" not in \
            runs["resumed"]["out"]:
        raise AssertionError(f"dp (c): the resumed run did not start from "
                             f"step {DP_FROM}")
    if len(err) != 26 or any(sh[0] != 1 for _, sh in err) or \
            not err_max > 0:
        raise AssertionError(f"dp (c): checkpoint {DP_FROM} holds residual "
                             f"leaves {err[:3]}... ({len(err)}), max "
                             f"{err_max}")
    ref = dict(read_losses(tmp / "whole.jsonl"))
    got = read_losses(tmp / "run.jsonl")
    want_keys = [("phase1", i) for i in range(1, DP_CRASH + 1)] + \
        [("phase1", i) for i in range(DP_FROM + 1, 5)] + [("phase2", 1)]
    if sorted(ref) != [("phase1", i) for i in range(1, 5)] + [
            ("phase2", 1)] or [k for k, _ in got] != want_keys:
        raise AssertionError(f"dp (c): logged {sorted(ref)} and {got}")
    differ = [(k, v.hex(), ref[k].hex()) for k, v in got
              if v.hex() != ref[k].hex()]
    for k, v in got:
        log(f"dp (c): {k[0]} step {k[1]} loss {v.hex()}, uninterrupted "
            f"{ref[k].hex()}")
    if differ:
        raise AssertionError(f"dp (c): losses differ from the "
                             f"uninterrupted run's bits: {differ}")
    timing = {tag: TIMING_LINE.findall(runs[tag]["out"])
              for tag in ("whole", "resumed")}
    calib = re.findall(r"(phase\d) timing calibration: compute ([\d.]+) ms "
                       r"\| serial step ([\d.]+) ms", runs["whole"]["out"])
    if not timing["whole"] or len(calib) != 2:
        raise AssertionError("dp (c): no compute_s / exchange_s / "
                             "overlap_frac in the log")
    for phase, compute_ms, serial_ms in calib:
        log(f"dp (c): {phase} timing calibration: compute twin "
            f"{compute_ms} ms, serial twin {serial_ms} ms (median of 3)")
    for tag, rows in timing.items():
        for phase, step, c, x, o in rows:
            log(f"dp (c): {tag} {phase} step {step}: compute_s {c}, "
                f"exchange_s {x}, overlap_frac {o}")
    quant = QUANT_LINE.findall(runs["whole"]["out"])
    if not quant:
        raise AssertionError("dp (c): no quantise_s / dequantise_s in the "
                             "log")
    for phase, step, qs, ds in quant:
        log(f"dp (c): whole {phase} step {step}: int8 quantise {qs} s, "
            f"dequantise {ds} s on the card (world 1: nothing to exchange)")
    for tag, run in runs.items():
        log(f"dp (c): {tag} run exit {run['rc']} in {run['s']:.1f} s; "
            "checkpoints " + "; ".join(
                f"{d} step {st} {what.split()[0]} {b} bytes in {sec:.3f} s"
                for st, what, d, b, sec in run["ckpt"])
            + ("" if run["launches"] is None else
               f"; training-loop launches {run['launches']}"))
    log(f"dp (c): checkpoint {DP_FROM}: {ckpt['bytes']} bytes, "
        f"{ckpt['leaves']} leaves, of them the residual group "
        f"{ckpt['residual_leaves']} leaves, {ckpt['residual_bytes']} "
        f"bytes, max |residual| {ckpt['residual_max']:.3g}; "
        f"{len(got)} losses equal in bits")
    return {"runs_s": {k: r["s"] for k, r in runs.items()}, "ckpt": ckpt,
            "timing": timing, "calib": calib, "quant": quant,
            "part_s": time.perf_counter() - t_part}


def dp_phase(ref_losses: list) -> dict:
    """(a) ``--dp`` at world 1 on NCCL through torchrun and the CLI, and
    (a') the same with ``--strategy bucketed --overlap`` (the uncompressed
    drain's asynchronous NCCL all-reduces started from the backward's leaf
    hooks), each held to ``ref_losses`` (step 8's in-process bf16 run) bit
    for bit; (c) the
    compressed exchange, the overlapped drain and the timing breakdown
    through the CLI, crash and resume included; (b) and (d) ``dp_check.py``
    with four gloo ranks sharing the card, the four strategies and then
    the compressed and overlapped cases.  (a), (a') and (c) run at the
    same time (up to four processes on the card: (c)'s uninterrupted and
    crashed runs start together): nothing of theirs is judged by its
    time, and (c)'s timing breakdown is read with the others running."""
    t_phase = time.perf_counter()
    cli_s = {}

    def world1(extra):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
            tmp = Path(tmp)
            run = dp_torchrun(tmp / "w", tmp / "loss.jsonl", extra)
            got = read_losses(tmp / "loss.jsonl") if run["rc"] == 0 else []
        return run, got
    def compressed():
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dpc_") as tmp:
            return dp_compressed_cli(Path(tmp))
    with concurrent.futures.ThreadPoolExecutor(len(DP_WORLD1) + 1) as pool:
        started_c = pool.submit(compressed)
        started = [(tag, extra, pool.submit(world1, extra))
                   for tag, extra in DP_WORLD1]
        done = [(tag, extra, *f.result()) for tag, extra, f in started]
        part_c = started_c.result()
    for tag, extra, run, got in done:
        cli_s[tag] = run["s"]
        out = run["out"]
        if run["rc"] != 0:
            raise AssertionError(f"dp {tag}: the torchrun --dp run exited "
                                 f"{run['rc']}:\n{out[-4000:]}")
        if "rank 0 of 1 (pod 0 of 1), nccl on cuda:0" not in out:
            raise AssertionError(f"dp {tag}: the --dp run did not run on "
                                 f"NCCL on cuda:0:\n{out[-4000:]}")
        for (key, loss), (want_key, want) in zip(got, ref_losses):
            log(f"dp {tag}: NCCL world 1 {key[0]} step {key[1]} loss "
                f"{loss.hex()}, in-process {want.hex()} ({want_key[0]} step "
                f"{want_key[1]})")
        if [k for k, _ in got] != [k for k, _ in ref_losses] or any(
                a.hex() != b.hex() for (_, a), (_, b) in zip(got, ref_losses)):
            raise AssertionError(f"dp {tag}: the NCCL world-1 losses {got} "
                                 f"are not the in-process run's {ref_losses}")
        missed = [k for k in TRAIN_KERNELS
                  if not (run["launches"] or {}).get(k, 0) > 0]
        if missed:
            raise AssertionError(f"dp {tag}: the --dp run never launched "
                                 f"{missed}")
        drained = ""
        if "--overlap" in extra:
            # every bucket of the last step started from a leaf hook, an
            # asynchronous NCCL all-reduce during the backward
            order = re.search(r"started buckets (\[[\d, ]*\]) of (\d+) "
                              r"during the backward", out)
            if not order or not json.loads(order[1]) or sorted(
                    json.loads(order[1])) != list(range(int(order[2]))):
                raise AssertionError(f"dp {tag}: the drain started no "
                                     f"bucket during the backward:\n"
                                     f"{out[-4000:]}")
            drained = (f", the last step's buckets started during the "
                       f"backward in order {order[1]} of {order[2]}")
        log(f"dp {tag}: NCCL world 1 through torchrun ({' '.join(extra)}): "
            f"{len(got)} losses equal in bits, training-loop launches "
            f"{run['launches']}{drained}, {run['s']:.1f} s")
    log(f"dp (c) on {nvidia_smi()}: {part_c['part_s']:.1f} s (runs "
        + ", ".join(f"{k} {v:.1f}" for k, v in part_c["runs_s"].items())
        + " s)")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dp_check",
                           *DP_CHECK_ARGS], env=_port_env(),
                          capture_output=True, text=True, timeout=900)
    check_s = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"dp: dp_check exited {proc.returncode}:\n"
                             f"{out[-6000:]}")
    for line in out.splitlines():
        if "repro_torch.dp_check" in line or "repro_torch.mesh" in line:
            log(f"dp: {line}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if not (res["world"] == 4 and res["pods"] == 2 and res["staged"]
            and res["layers"] == DP_LAYERS and res["d_model"] == 1024):
        raise AssertionError(f"dp: dp_check ran {res}")
    if list(res["strategies"]) != list(DP_CASES):
        raise AssertionError(f"dp: dp_check ran {list(res['strategies'])}")
    for case, rec in res["strategies"].items():
        ranks = rec["ranks"]
        missed = [(r, k) for r, rank in enumerate(ranks)
                  for k in DP_KERNELS if not rank["launches"][k] > 0]
        comp = rec["compression"] != "none"
        bad = (not rec["digests_equal"] or missed
               or rec["loss_vs_psum"] > 1e-5
               or (rec["overlap"] and rec.get("serial_bits") is not True)
               or (comp and (
                   len({r["residual_digest"] for r in ranks}) != len(ranks)
                   or any(r["grads_vs_psum"]["outside_tol"]
                          or not r["residual_max"] > 0 for r in ranks)))
               or (not comp and any(r["vs_psum"]["outside_tol"]
                                    for r in ranks)))
        if bad:
            raise AssertionError(f"dp: {case}: {rec}")
        log(f"dp: {case} world 4 (2 pods), gloo staged: loss "
            f"{rec['loss']!r} (vs psum {rec['loss_vs_psum']:.3g}), digests "
            f"equal, exchange_bytes_per_step {rec['exchange_bytes']:.0f} B a "
            f"rank ({rec['compression']}); exchange s a rank " + ", ".join(
                f"{r['exchange_s']:.4f}" for r in ranks)
            + "; step s " + ", ".join(f"{r['step_s']:.3f}" for r in ranks)
            + "; peak GiB " + ", ".join(f"{r['peak_gib']:.2f}"
                                        for r in ranks)
            + f"; masters vs psum {ranks[0]['vs_psum']}"
            + ("" if "serial_bits" not in rec else
               f"; the serial case's bits {rec['serial_bits']}"))
        if comp:
            log(f"dp: {case}: quantise s a rank " + ", ".join(
                f"{r['compress_s'].get('quantise', 0.0):.4f}" for r in ranks)
                + "; dequantise s a rank " + ", ".join(
                f"{r['compress_s'].get('dequantise', 0.0):.4f}"
                for r in ranks)
                + f" (within the exchange); gradients vs psum's "
                f"{ranks[0]['grads_vs_psum']}; residual max "
                + ", ".join(f"{r['residual_max']:.3g}" for r in ranks)
                + "; residuals differ by rank")
    phase_s = time.perf_counter() - t_phase
    log(f"dp on {nvidia_smi()}: torchrun world 1 " + ", ".join(
        f"{k} {v:.1f} s" for k, v in cli_s.items()) + ", (c) "
        f"{part_c['part_s']:.1f} s, (b) + "
        f"(d) dp_check {check_s:.1f} s ({res['seconds']:.1f} s in its "
        f"ranks), phase {phase_s:.1f} s")
    return {"cli_s": cli_s, "c_s": part_c["part_s"], "check_s": check_s,
            "phase_s": phase_s}


# ---------------------------------------------------------------------------
# decoder-LM training phase
# ---------------------------------------------------------------------------

# the LM path: deepseek-7b at full width and 4 layers, global batches of 8 x
# 1024 tokens in 2 micro-batches (LM_PATHS), 4 steps in bf16; its
# attention calls are (micro-batch, heads, S, Dh) = LM_ATTN, causal
LM_LAYERS, LM_BATCH, LM_SEQ, LM_ACCUM = LM_PATHS["deepseek-7b"]
LM_STEPS = 4
LM_ATTN = (LM_BATCH // LM_ACCUM, 32, LM_SEQ, 128)
LM_ARGS = ["--arch", "deepseek-7b", "--full", "--layers", str(LM_LAYERS),
           "--batch", str(LM_BATCH), "--seq", str(LM_SEQ), "--accum",
           str(LM_ACCUM), "--steps", str(LM_STEPS), "--precision", "bf16",
           "--device", DEVICE, "--seed", str(SEED), "--log-every", "1"]
# a step's flash launches: each layer's forward twice a micro-batch (the
# checkpoint recompute in the backward) and its backward once; at S 1024
# the backward runs its pre-pass, main pass and, over 8 KV tiles, its
# post-pass every call
LM_FWD_PER_STEP = 2 * LM_LAYERS * LM_ACCUM
LM_BWD_PER_STEP = LM_LAYERS * LM_ACCUM
LM_HELD = ("flash_attention", "flash_attention_bwd", "lamb_moments")
# a held LAMB call over more elements than this runs its plain version a
# slice at a time (``held_against_plain``)
HOLD_SLICE = 2 ** 27
# kernel path vs plain path of one LM training step (LAMB) from the same
# state on the same batch, per dtype, as TRAIN_BOUND holds BERT's: |loss
# difference| / |loss|, the largest relative L2 difference of a gradient
# group and of a group's master update.  Measured on the H100 (the seeds
# fix the data, so the readings repeat): f32 loss 7.9e-8, worst gradient
# group 6.2e-6 (blocks.mixer.wq), worst update 8.6e-5 (the same group:
# LAMB's first step is m / sqrt(v) = g / |g| per element, so gradients
# near 0 move the update far more than the gradients); bf16 loss 9.1e-6,
# gradients 1.8e-2 (blocks.mixer.wq), update 4.9e-2 (embed.tok).  The
# bounds sit 3-12x above the readings.
LM_BOUND = {torch.float32: {"loss": 1e-6, "grad": 1e-4, "update": 5e-4},
            torch.bfloat16: {"loss": 5e-5, "grad": 5e-2, "update": 0.15}}
# rwkv6-1.6b's time mix normalises each head's output (its group norm),
# so the gradients of u and of r's and k's weights are what the norm's
# projection leaves of larger terms, and bf16 rounding of those terms
# moves them far: at full width one time mix's u gradient in bf16 lies
# 0.43 from f32, in the reference as in the port, and 7e-3 with the norm's
# scale a constant (``tests/torch_rwkv_bf16_gap.py --time-mix``).  Each
# layer multiplies it: at 24 layers the plain bf16 gradients lay 17-25x
# their norm from plain f32 and kernels vs plain ~1 apart.  So rwkv's
# bf16 step is held to LM_BOUND at one layer, the plain f32 path's
# distance logged beside it (``lm_train_parity(floor=True)``); the
# 24-layer CLI run holds launches and finite, taken steps.
# the crash -> resume and data-parallel runs of the CLI: the smoke
# deepseek-7b (Dh 32) at S 1024, so attention takes the flash pair; 7 steps
# of 4 x 1024 tokens with checkpoints at 3 and 6 (and 7, the end); the
# crash after step 5 leaves checkpoint 3
LM_SMOKE_ARGS = ["--arch", "deepseek-7b", "--smoke", "--steps", "7",
                 "--batch", "4", "--seq", "1024", "--precision", "bf16",
                 "--optimizer", "adamw", "--log-every", "1", "--device",
                 DEVICE, "--seed", str(SEED)]
LM_CRASH, LM_FROM = 5, 3
LM_FLASH = ("flash_fwd", "flash_bwd_prep", "flash_bwd", "flash_bwd_post")
LAUNCH_LINE = re.compile(r"training-loop kernel launches (\{[^}]*\})")


def lm_flash_phase(ops, fa, timer) -> dict:
    """The causal flash forward and whole backward at the LM path's shape
    LM_ATTN (Dh 128: the backward's main pass is the ``mma.sync`` kernel,
    the ``wgmma`` one serving Dh 64), in bf16 and f16, in the model's
    (B, S, H, Dh) layout: each held against its plain version (TOL and
    CALL_REL_L2_BOUND) and launched twice for the same bits, then timed
    beside SDPA's causal forward and backward, the plain version and the
    bound (the backward also a launch at a time).  Returns the bf16
    entries."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    b, h, s, dh = LM_ATTN
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entries = {}
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, do = (torch.randn((b, s, h, dh), generator=gen,
                                   device=DEVICE).to(dtype).transpose(1, 2)
                       for _ in range(4))
        out, lse = ops.flash_attention(q, k, v, causal=True)
        want = ops.flash_attention(q, k, v, causal=True, impl="torch")
        torch.cuda.synchronize()
        fwd = [check_grad(f"lm flash fwd {dtype} {n}", g, w, dtype)
               for g, w, n in zip((out, lse), want, ("out", "lse"))]
        check_same_bits(f"lm flash fwd {dtype}", (out, lse),
                        ops.flash_attention(q, k, v, causal=True))
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
        want = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                       impl="torch")
        torch.cuda.synchronize()
        bwd = [check_grad(f"lm flash bwd {dtype} d{n}", g, w, dtype)
               for g, w, n in zip(got, want, "qkv")]
        check_same_bits(f"lm flash bwd {dtype}", got, fa.flash_attention_bwd(
            q, k, v, out, lse, do, causal=True))
        del got, want
        fwd_t = timer.times(lambda: ops.flash_attention(q, k, v,
                                                        causal=True))
        bwd_t = timer.times(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, causal=True))
        bufs = fa.bwd_buffers(q, s)
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        parts = {name: timer.times(lambda: fa.bwd_launch(
            part, q, k, v, out, lse, do, bufs, grads, causal=True, window=0,
            softcap=0.0)) for name, part in (
                ("pre-pass", fa.PREP), ("main pass", fa.MAIN),
                ("post-pass", fa.POST)) if part & fa.bwd_parts(bufs)}
        del bufs, grads
        fwd_plain = timer.ms(lambda: ops.flash_attention(
            q, k, v, causal=True, impl="torch"))
        bwd_plain = timer.ms(lambda: ops.flash_attention_bwd(
            q, k, v, out, lse, do, causal=True, impl="torch"))
        lib_fwd_t = timer.times(lambda: sdpa(q, k, v, is_causal=True))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = sdpa(qg, kg, vg, is_causal=True)
        lib_bwd_t = timer.times(lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), do, retain_graph=True))
        del sdpa_out, qg, kg, vg
        fb = flash_fwd_bound(b, h, s, dh, causal=True, item=2)
        bb = flash_bwd_bound(b, h, s, dh, causal=True, item=2)
        ms = {"fwd": float(np.mean(fwd_t)), "bwd": float(np.mean(bwd_t)),
              "sdpa_fwd": float(np.mean(lib_fwd_t)),
              "sdpa_bwd": float(np.mean(lib_bwd_t))}
        log(f"lm flash {LM_ATTN} {dtype} causal: forward max err "
            f"{max(e for e, _ in fwd):.3e} (rel L2 "
            f"{max(r for _, r in fwd):.3e}), {ms['fwd']:.4f} ms "
            f"({ms['fwd'] / ms['sdpa_fwd']:.2f}x sdpa forward "
            f"{ms['sdpa_fwd']:.4f}), plain {fwd_plain:.4f} ms, bound "
            f"{fb[0]:.4f} ms ({fb[1]}); backward max err "
            f"{max(e for e, _ in bwd):.3e} (rel L2 "
            f"{max(r for _, r in bwd):.3e}), {ms['bwd']:.4f} ms "
            f"({' + '.join(parts)}; {ms['bwd'] / ms['sdpa_bwd']:.2f}x sdpa "
            f"backward {ms['sdpa_bwd']:.4f}), plain {bwd_plain:.4f} ms, "
            f"bound {bb[0]:.4f} ms ({bb[1]}); forward and backward each two "
            f"launches the same bits; forward {spread(fwd_t)}; backward "
            f"{spread(bwd_t)}; sdpa forward {spread(lib_fwd_t)}; sdpa "
            f"backward {spread(lib_bwd_t)}; " + "; ".join(
                f"{n} {spread(t)}" for n, t in parts.items()))
        if dtype == torch.bfloat16:
            entries["flash_fwd_lm"] = entry(
                "flash_fwd_lm", "flash_fwd.cu", "flash_attention.py:132",
                max(e for e, _ in fwd), ms["fwd"], fwd_plain, *fb,
                ms["sdpa_fwd"])
            entries["flash_bwd_lm"] = entry(
                "flash_bwd_lm", "flash_bwd.cu", "flash_attention.py:272",
                max(e for e, _ in bwd), ms["bwd"], bwd_plain, *bb,
                ms["sdpa_bwd"])
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return entries


def lm_train_run(ops, train, optimizer) -> dict:
    """``launch/train.py`` with LM_ARGS and ``--optimizer``, launch counts
    zeroed just before and read just after.  Every step must be finite and
    taken (bf16), the flash forward and backward must launch their
    kernels LM_FWD_PER_STEP and LM_BWD_PER_STEP times a step at S 1024 and
    nowhere else, LAMB's kernel once a leaf group a step under LAMB and
    never under AdamW, and no other kernel."""
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, state, history = train.run(LM_ARGS + ["--optimizer", optimizer])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_groups = len(state.opt.groups.paths)
    n_params = sum(t.numel() for t in state.opt.master.values())
    del state
    torch.cuda.empty_cache()
    for r in history:
        log(f"lm train {optimizer} step {r['step']:.0f}: loss {r['loss']:.4f}"
            f" ({r['loss'].hex()}), grad norm {r['grad_norm']:.4f}, lr "
            f"{r['lr']:.3g}, skipped {bool(r['skipped'])}, {r['ms']:.1f} ms")
    if [r["step"] for r in history] != list(range(1, LM_STEPS + 1)) or any(
            r["skipped"] or not np.isfinite(r["loss"]) for r in history):
        raise AssertionError(f"lm train {optimizer}: expected {LM_STEPS} "
                             f"finite steps, got {history}")
    want = {"flash_fwd": LM_FWD_PER_STEP * LM_STEPS,
            f"flash_fwd_s{LM_SEQ}": LM_FWD_PER_STEP * LM_STEPS,
            "lamb_moments": n_groups * LM_STEPS if optimizer == "lamb" else 0}
    for k in ("flash_bwd_prep", "flash_bwd", "flash_bwd_post",
              f"flash_bwd_s{LM_SEQ}"):
        want[k] = LM_BWD_PER_STEP * LM_STEPS
    got = {k: n for k, n in counts.items() if n}
    if got != {k: n for k, n in want.items() if n}:
        raise AssertionError(f"lm train {optimizer}: launches {got}, "
                             f"expected {want}")
    log(f"lm train deepseek-7b full width {optimizer}: {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {n_params / 1e9:.4f} B parameters "
        f"in {n_groups} leaf groups; launches {got}; peak device memory "
        f"{peak:.2f} GiB; {run_s:.1f} s (init included) on {nvidia_smi()}")
    return {"counts": counts, "history": history, "peak_gib": peak,
            "s": run_s}


def lm_train_parity(ops, api, ts, TrainConfig, make_policy, lm_batches,
                    cfg, precision, *, geometry=(LM_BATCH, LM_SEQ, LM_ACCUM),
                    held=None, prepare=None, tag="lm",
                    floor: bool = False) -> dict:
    """One LAMB step of the LM path from a fresh state on the stream's
    first batch of ``geometry`` (batch, seq, accumulation), through the
    plain versions and through the kernels (every call of ``held``, by
    default LM_HELD, held against its plain version on its inputs:
    ``{name: (dtype, rms)}`` as ``held_against_plain`` takes it);
    ``prepare(params)`` may redraw weights first.  The card holds one
    training state at a time: the plain path's gradients (as the clip
    takes them) and master update wait in host memory, and each later
    path is compared with them a group at a time on the card.

    With ``floor`` (a 16-bit step) the plain path also runs in f32, and
    each group's floor, how far the plain 16-bit gradient and update lie
    from the plain f32 ones, is logged beside the group's reading: what
    16-bit arithmetic itself makes of the step, a yardstick for the
    kernels-vs-plain distance, which LM_BOUND judges all the same.  The
    largest group reading of each kind is returned (``grad_rel``,
    ``update_rel``), and with ``floor`` the largest floor of each kind
    (``grad_floor``, ``update_floor``)."""
    pol = make_policy(precision)
    batch_n, seq, accum = geometry
    held = held or {k: (None, False) for k in LM_HELD}
    batch = api.to_device(next(lm_batches(SEED, cfg.vocab_size, batch_n,
                                          seq)), DEVICE)
    record = {name: [] for name in held}
    # the plain path first: its gradients and updates on the host; each
    # later path's (kernel, and with ``floor`` plain f32) as
    # {kind: {group: (||later - plain||, ||later||)}}
    ref = {"grad": {}, "update": {}}
    dist = {}
    runs = {}
    paths = [("torch", precision), (None, precision)]
    if floor:
        paths.append(("torch", "f32"))

    def params():
        p = api.init_params(cfg, seed=SEED + 1, device=DEVICE)
        if prepare is not None:
            prepare(p)
        return p

    def against_ref(kind, vals, out):
        for g, t in vals.items():
            r = ref[kind][g].to(DEVICE)
            out[g] = (float((t - r).norm()), float(t.norm()),
                      float(r.norm()))
            del r

    for impl, prec in paths:
        key = (impl, prec)
        tcfg = TrainConfig(precision=prec, accum_steps=accum,
                           optimizer="lamb", total_steps=LM_STEPS,
                           warmup_steps=2)
        state = ts.init_train_state(params(), make_policy(prec), tcfg,
                                    cfg=cfg)
        dist[key] = {"grad": {}, "update": {}}
        finite = []

        def keep(g, key=key):
            finite.append(all(bool(torch.isfinite(t).all())
                              for t in g.values()))
            if key == paths[0]:
                ref["grad"].update({p: t.to("cpu", copy=True)
                                    for p, t in g.items()})
            else:
                against_ref("grad", g, dist[key]["grad"])
        with (held_against_plain(ops, record, held)
              if impl is None else contextlib.nullcontext()):
            state, metrics = ts.train_step_fn(
                state, batch, cfg=cfg, tcfg=tcfg, policy=make_policy(prec),
                impl=impl, on_grads=keep)
            torch.cuda.synchronize()
        old = state.opt.groups.flatten(params())
        upd = {p: state.opt.master[p] - old.pop(p)
               for p in list(state.opt.master)}
        if key == paths[0]:
            ref["update"].update({p: t.to("cpu") for p, t in upd.items()})
        else:
            against_ref("update", upd, dist[key]["update"])
        runs[key] = (float(metrics["loss"]), finite[0],
                     {k: metrics[k] for k in ("skipped", "loss_scale")})
        del state, old, upd
        torch.cuda.empty_cache()
    (lp, _, mp), (lk, fin, mk) = runs[paths[0]], runs[paths[1]]
    bd = LM_BOUND[pol.compute_dtype]
    res = {"dtype": pol.compute_dtype, "loss_rel": abs(lk - lp) / abs(lp),
           "loss": (lk, lp), "finite": fin, "same_step": mk == mp,
           "step": mk, **call_summary(record)}
    notes = []
    for kind in ("grad", "update"):
        # kernels vs plain: ||k - p|| / ||p||; the floor: ||f - p|| / ||f||
        rels = {p: d / max(n_ref, 1e-30) for p, (d, _, n_ref) in
                dist[paths[1]][kind].items()}
        floors = ({p: d / max(n, 1e-30) for p, (d, n, _) in
                   dist[paths[2]][kind].items()} if floor
                  else {p: 0.0 for p in rels})
        res[f"{kind}_rel"] = max(rels.values())
        res[f"{kind}_floor"] = max(floors.values())
        top = sorted(rels, key=rels.get, reverse=True)[:3]
        notes.append(f"{kind}: largest " + ", ".join(
                         f"{'.'.join(p)} {rels[p]:.3e}"
                         + (f" (floor {floors[p]:.3e})" if floor else "")
                         for p in top))
    log(f"{tag} train parity {precision} ({cfg.n_layers} layers, "
        f"{batch_n} x {seq} tokens in {accum} micro-batches): loss "
        f"{lk:.6f} (kernels) vs {lp:.6f} (plain)"
        + (f" vs {runs[paths[2]][0]:.6f} (plain f32)" if floor else "")
        + f", rel {res['loss_rel']:.3e}; " + "; ".join(notes)
        + (f"; largest floors {res['grad_floor']:.3e} (gradients), "
           f"{res['update_floor']:.3e} (updates)" if floor else "")
        + f" (LM_BOUND {bd}); step {mk} (kernels) vs "
        f"{mp} (plain); each kernel call vs plain on its inputs: " + ", ".join(
            f"{k} {res['calls_outside'][k]}/{res['calls'][k]} outside, max "
            f"err {res['call_max_err'][k]:.3e}, max rel L2 "
            f"{res['call_max_rel'][k]:.3e}" for k in record))
    return res


def lm_cli(tmp: Path, tag: str, extra=(), faults: str = "",
           torchrun: bool = False, out: str = "") -> subprocess.Popen:
    """One process of ``python -m repro_torch.launch.train`` with
    LM_SMOKE_ARGS, its loss log ``<tmp>/<tag>.jsonl`` (through torchrun
    at world 1 with ``torchrun``), its output in ``<tmp>/<out or
    tag>.out`` (a file: a pipe nobody reads while this process works
    could fill and stall it)."""
    env = _port_env()
    if faults:
        env["REPRO_FAULTS"] = faults
    cmd = [sys.executable, "-m", "repro_torch.launch.train"]
    if torchrun:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "-m", "repro_torch.launch.train"]
    with open(tmp / f"{out or tag}.out", "w") as f:
        proc = subprocess.Popen(
            cmd + [*LM_SMOKE_ARGS, "--loss-log", str(tmp / f"{tag}.jsonl"),
                   *extra], env=env, stdout=f, stderr=subprocess.STDOUT,
            text=True, start_new_session=True)
    proc.out_path = tmp / f"{out or tag}.out"
    return proc


def lm_wait(tag: str, proc: subprocess.Popen, rc: int,
            t0: float) -> dict:
    """Wait for ``proc`` (killed with its group after 600 s); its exit
    must be ``rc`` (torchrun exits 1 and names its rank's code), and a
    run that ended must have launched every flash kernel."""
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        raise AssertionError(f"lm {tag}: timed out:\n"
                             f"{proc.out_path.read_text()[-4000:]}")
    out = proc.out_path.read_text()
    if (proc.returncode == 0) != (rc == 0) or (
            rc and proc.returncode != rc
            and not re.search(rf"exitcode\s*:\s*{rc}", out)):
        raise AssertionError(f"lm {tag}: exit {proc.returncode}, not {rc}:"
                             f"\n{out[-4000:]}")
    launches = LAUNCH_LINE.search(out)
    launches = json.loads(launches[1]) if launches else {}
    missed = [k for k in LM_FLASH if rc == 0 and not launches.get(k, 0) > 0]
    if missed:
        raise AssertionError(f"lm {tag}: never launched {missed}:\n"
                             f"{out[-4000:]}")
    return {"out": out, "launches": launches, "s": time.perf_counter() - t0}


def lm_resume_phase(latest_step, during=None) -> dict:
    """The decoder trainer's CLI on the card at the smoke size: an
    uninterrupted run, one crashed by ``REPRO_FAULTS=crash_at=LM_CRASH``
    (exit 43, newest checkpoint LM_FROM) and the crashed one resumed; and
    the same run with ``--dp --strategy ring`` through torchrun at world 1
    on NCCL.  Every loss of the faulted runs and of the data-parallel run
    must have the uninterrupted run's float32 bits.  The uninterrupted,
    crashed and data-parallel runs start together, and ``during()`` (work
    of this process that times nothing) runs while they do; the resumed run
    starts once the crashed one has ended."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        tmp = Path(tmp)
        ckpt = ["--ckpt-every", "3", "--ckpt-dir", str(tmp / "ckpt")]
        t0 = time.perf_counter()
        procs = {"dp": (lm_cli(tmp, "dp", ["--dp", "--strategy", "ring"],
                               torchrun=True), 0),
                 "whole": (lm_cli(tmp, "whole", [
                     "--ckpt-every", "3", "--ckpt-dir",
                     str(tmp / "whole_ckpt")]), 0),
                 "crash": (lm_cli(tmp, "run", ckpt, out="crash",
                                  faults=f"crash_at={LM_CRASH}"), 43)}
        if during is not None:
            during()
        runs = {"crash": lm_wait("crash", *procs.pop("crash"), t0)}
        last = latest_step(str(tmp / "ckpt"))
        t1 = time.perf_counter()
        resumed = lm_cli(tmp, "run", ckpt + ["--resume"], out="resumed")
        runs.update({k: lm_wait(k, *v, t0) for k, v in procs.items()})
        runs["resumed"] = lm_wait("resumed", resumed, 0, t1)
        ref = dict(read_lm_losses(tmp / "whole.jsonl"))
        got = read_lm_losses(tmp / "run.jsonl")
        dp_got = read_lm_losses(tmp / "dp.jsonl")
    if sorted(ref) != list(range(1, 8)) or last != LM_FROM:
        raise AssertionError(f"lm resume: uninterrupted steps {sorted(ref)}, "
                             f"newest checkpoint {last}")
    if f"resumed from checkpoint step {LM_FROM} in" not in \
            runs["resumed"]["out"]:
        raise AssertionError(f"lm resume: the resumed run did not start "
                             f"from step {LM_FROM}")
    if [s for s, _ in got] != list(range(1, LM_CRASH + 1)) + list(
            range(LM_FROM + 1, 8)):
        raise AssertionError(f"lm resume: the faulted runs logged {got}")
    if "rank 0 of 1 (pod 0 of 1), nccl on cuda:0" not in runs["dp"]["out"]:
        raise AssertionError("lm dp: the --dp run did not run on NCCL on "
                             f"cuda:0:\n{runs['dp']['out'][-4000:]}")
    if [s for s, _ in dp_got] != sorted(ref):
        raise AssertionError(f"lm dp: logged {dp_got}")
    differ = [(tag, s, v.hex(), ref[s].hex())
              for tag, rows in (("resume", got), ("dp", dp_got))
              for s, v in rows if v.hex() != ref[s].hex()]
    for s, v in got:
        log(f"lm resume: step {s} loss {v.hex()} ({v:.6f}), uninterrupted "
            f"{ref[s].hex()}")
    for s, v in dp_got:
        log(f"lm dp: NCCL world 1 ring step {s} loss {v.hex()}, serial "
            f"{ref[s].hex()}")
    res = {"compared": len(got) + len(dp_got), "differ": differ,
           "runs_s": {k: r["s"] for k, r in runs.items()},
           "launches": {k: r["launches"] for k, r in runs.items()},
           "phase_s": time.perf_counter() - t_phase}
    log(f"lm resume and dp on {nvidia_smi()}: smoke deepseek-7b at S "
        f"{LM_SEQ}, runs " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                       res["runs_s"].items())
        + f" from each start to its wait (the first three waited for after "
        f"the in-process steps), launches {res['launches']}; "
        f"{res['compared']} losses compared bit for bit, {len(differ)} "
        f"differ; phase {res['phase_s']:.1f} s")
    if differ:
        raise AssertionError(f"lm resume/dp: losses differ from the "
                             f"uninterrupted run's bits: {differ}")
    return res


def read_lm_losses(path: Path) -> list:
    """(step, loss) for each line of a decoder ``--loss-log`` file."""
    return [(r["step"], r["loss"]) for r in
            map(json.loads, path.read_text().splitlines())]


def lm_embedding_probe(probe_embedding, lm_batches) -> None:
    """A reading, not judged: ``F.embedding``'s backward of the token
    table, 8 times on one output gradient, at the LM path's micro-batch of
    the full-width table (102400 x 4096) and of the smoke table (512 x
    256), beside indexing (``determinism_check.probe_embedding``)."""
    for vocab, d in ((102400, 4096), (512, 256)):
        toks = torch.from_numpy(next(lm_batches(
            SEED, vocab, LM_BATCH, LM_SEQ))["tokens"][:, :-1]).to(DEVICE)
        rows = probe_embedding({"tokens": toks.long(),
                                "type_ids": torch.zeros_like(toks).long()},
                               d, vocab, 8, DEVICE)
        for r in rows:
            if r["table"] == "tok":
                log(f"lm embedding probe: vocab {vocab} x d {d}, "
                    f"{r['ids']} ids ({r['distinct_ids']} distinct), "
                    f"{r['form']}: {r['differ']} of {r['runs'] - 1} "
                    f"backwards differ from the first, {r['ms']:.3f} ms")
        torch.cuda.empty_cache()


def lm_phase(ops, fa) -> dict:
    """The decoder-LM phase: the flash pair at the path shape, LAMB over
    the LM's largest leaf group, the embedding probe, two CLI training runs
    at full width (LAMB, AdamW), the kernels-vs-plain step in f32 and bf16,
    and the smoke crash -> resume and NCCL world-1 runs.  Returns the
    kernel entries and the runs' launch counts."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.amp import make_policy
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch import train
    from repro_torch.launch.determinism_check import probe_embedding
    from repro_torch.models import api
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import latest_step

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=LM_LAYERS)
    timer = Timer()
    entries = lm_flash_phase(ops, fa, timer)
    # the largest LAMB leaf group of the LM: the 102400 x 4096 embedding
    # (and the LM head)
    entries["lamb_moments_lm"] = lamb_phase(
        ops, timer, cfg.vocab_size * cfg.d_model, tag="lamb_moments_lm")
    del timer
    torch.cuda.empty_cache()
    lm_embedding_probe(probe_embedding, lm_batches)
    runs = {opt: lm_train_run(ops, train, opt) for opt in ("lamb", "adamw")}

    def parity():     # while the smoke runs run: nothing here is timed
        for precision in ("f32", "bf16"):
            check_train_parity(lm_train_parity(
                ops, api, ts, TrainConfig, make_policy, lm_batches, cfg,
                precision), LM_BOUND)
            torch.cuda.empty_cache()
    resume = lm_resume_phase(latest_step, during=parity)
    log(f"lm phase on {nvidia_smi()}: {time.perf_counter() - t_phase:.1f} s "
        f"(the kernels-vs-plain steps and the smoke runs together "
        f"{resume['phase_s']:.1f} s)")
    return {"entries": entries, "runs": runs}


def deepseek_serve_phase(T, ops, serve_step, sched_mod, get_config,
                         make_policy) -> dict:
    """Step 4: full-width deepseek-7b served in bf16 (the paged and int8
    runs, the prefix cache and cohort runs, kernels vs plain), then the
    kernels-vs-plain check in f32.  Returns each run's launch counts."""
    cfg = get_config("deepseek-7b")
    pol = make_policy("bf16")
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed=SEED, dtype=pol.param_dtype,
                          device=DEVICE)
    torch.cuda.synchronize()
    log(f"deepseek-7b full width: {cfg.param_count() / 1e9:.3f} B params "
        f"(bf16) made in {time.perf_counter() - t0:.1f} s")

    launches = {}
    for mode in ("paged", "paged_int8"):
        launches[mode] = serve_run(T, ops, sched_mod, cfg, params, pol, mode)
        torch.cuda.empty_cache()
    for mode in ("paged", "paged_int8"):
        check_parity(path_parity(T, serve_step, ops, cfg, params, pol, mode))
    launches.update(prefix_cohort_phase(T, serve_step, ops, sched_mod, cfg,
                                        params, pol))
    # the same check in f32, where only summation order separates the paths
    del params
    torch.cuda.empty_cache()
    pol32 = make_policy("f32")
    params = T.init_model(cfg, seed=SEED, dtype=pol32.param_dtype,
                          device=DEVICE)
    for mode in ("paged", "paged_int8"):
        check_parity(path_parity(T, serve_step, ops, cfg, params, pol32,
                                 mode))
    del params
    torch.cuda.empty_cache()
    log(f"peak device memory (deepseek serving) "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# the dense decoder variants: gemma2-27b, qwen1.5-32b, deepseek-coder-33b
# ---------------------------------------------------------------------------

# full width, depth cut: gemma2 4 local/global blocks, qwen and coder 4
# layers; the f32 holds take 2 layers of each
DECODER_LAYERS = {"gemma2-27b": 8, "qwen1.5-32b": 4, "deepseek-coder-33b": 4}
DECODER_F32_LAYERS = 2
# gemma2's raw prefill: 2 prompts of 8192 tokens, twice its 4096-token
# window, so the flash forward's window mask bites on the local layers and
# their rings keep the last 4096 positions (8192 % 4096 == 0: the first
# decode write wraps to row 0); then 16 greedy decode steps
GEMMA_BATCH, GEMMA_PROMPT, GEMMA_NEW = 2, 8192, 16
# gemma2's continuous run: the bucket is the window (a slot prefill cannot
# roll a ring), 8 requests of 600-4096 tokens and 4-16 new tokens
GEMMA_BUCKET, GEMMA_MAX_LEN = 4096, 4224
# qwen1.5-32b's QKV biases are drawn at this std (init leaves zeros): about
# the spread of x wq at full width, so the bias path carries weight
QKV_BIAS_STD = 1.0
# the paged yardstick at deepseek-coder-33b's group: 56 query heads over 8
# KV heads, the serve geometry's slots
CODER_HEADS = (56, 8)


def draw_biases(params) -> None:
    """Draw every layer's QKV biases from a seed at ``QKV_BIAS_STD``, in
    place (init leaves zeros)."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    for layer in params["blocks"]:
        for name in ("bq", "bk", "bv"):
            b = layer["mixer"][name]
            b.copy_(L.trunc_normal(tuple(b.shape), gen, stddev=QKV_BIAS_STD,
                                   dtype=b.dtype, device=DEVICE))


def decoder_model(T, get_config, arch, layers, pol):
    """(config at ``layers`` layers, seeded weights on the card); QKV
    biases drawn from a seed at ``QKV_BIAS_STD``."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    params = T.init_model(cfg, seed=SEED, dtype=pol.param_dtype,
                          device=DEVICE)
    if cfg.qkv_bias:
        draw_biases(params)
    torch.cuda.synchronize()
    return cfg, params


def check_held(tag: str, record, dtype) -> None:
    """Every held call within TOL[dtype] and CALL_REL_L2_BOUND[dtype]."""
    for k, calls in record.items():
        if not calls:
            raise AssertionError(f"{tag}: {k} was never called")
        bad = sum(not c.ok for c in calls)
        worst = max(c.rel for c in calls)
        if bad or not worst <= CALL_REL_L2_BOUND[dtype]:
            raise AssertionError(f"{tag}: {bad} of {len(calls)} {k} calls "
                                 f"outside {TOL[dtype]}, worst rel L2 "
                                 f"{worst:.3e}")


def gemma_raw_run(ops, serve, cfg, params, pol) -> dict:
    """The serve CLI's raw mode (``run_raw``): 2 prompts of 8192 tokens,
    16 new tokens.  The prefill launches the flash forward once a layer at
    S 8192 (window 4096 and softcap 50 on the local layers, softcap on the
    global ones), each launch held against its plain version; decode reads
    the rings through ``naive_attention`` (the reference's jnp form: no
    kernel on either side).  ``run_raw`` raises on a non-finite logit
    row."""
    args = serve.build_parser().parse_args([
        "--arch", cfg.arch_id, "--full-width", "--mode", "raw", "--batch",
        str(GEMMA_BATCH), "--prompt-len", str(GEMMA_PROMPT), "--new-tokens",
        str(GEMMA_NEW), "--device", DEVICE])
    record = {"flash_attention": []}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with held_against_plain(ops, record, {"flash_attention": (
            pol.compute_dtype, False)}):
        ids = serve.run_raw(args, cfg, pol, params)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    if ids.shape != (GEMMA_BATCH, GEMMA_NEW):
        raise AssertionError(f"gemma2 raw: generated {ids.shape}")
    if counts["flash_fwd"] != cfg.n_layers or \
            counts.get(f"flash_fwd_s{GEMMA_PROMPT}") != cfg.n_layers or \
            counts["paged_decode"]:
        raise AssertionError(f"gemma2 raw: launches {counts}; expected the "
                             f"flash forward once a layer at S "
                             f"{GEMMA_PROMPT} and no paged decode")
    check_held("gemma2 raw", record, pol.compute_dtype)
    res = call_summary(record)
    log(f"gemma2 raw ({cfg.n_layers} layers, full width): {GEMMA_BATCH} x "
        f"{GEMMA_PROMPT} prompt tokens, {GEMMA_NEW} new, {wall:.3f} s with "
        f"each flash call held (worst max err "
        f"{res['call_max_err']['flash_attention']:.3e}, rel L2 "
        f"{res['call_max_rel']['flash_attention']:.3e}); launches {counts}")
    return counts


def gemma_parity(T, ops, cfg, params, pol, batch, new) -> dict:
    """``batch`` prompts of 8192 tokens prefilled and ``new`` decode steps
    taken through the kernels and through the plain versions, fed the same
    tokens; every flash call of the kernel path held against its plain
    version on its inputs.  Returns the readings in ``path_parity``'s
    form."""
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch, GEMMA_PROMPT), dtype=np.int32)).to(
            DEVICE)
    record = {"flash_attention": []}
    feed, logits = [], {}
    with held_against_plain(ops, record, {"flash_attention": (
            pol.compute_dtype, False)}):
        for impl in (None, "torch"):
            state = T.init_decode_state(cfg, batch, GEMMA_PROMPT + new,
                                        pol.compute_dtype, device=DEVICE)
            rows = [st["cache"]["k"].shape[1] for st in state["blocks"]]
            if rows[0] != cfg.sliding_window or \
                    rows[1] != GEMMA_PROMPT + new:
                raise AssertionError(f"gemma2: cache rows {rows}")
            lg, state = T.prefill(params, toks, cfg, pol, state=state,
                                  impl=impl)
            seq = [lg]
            for i in range(new):
                if impl is None:
                    feed.append(lg.argmax(-1, keepdim=True))
                lg, state = T.decode_step(params, feed[i], state, cfg, pol,
                                          impl=impl)
                seq.append(lg)
            logits[impl] = torch.stack(seq).float()
            del state
    a, b = logits[None], logits["torch"]
    res = {"mode": f"gemma2 raw {batch} x {GEMMA_PROMPT} + {new}",
           "dtype": pol.compute_dtype,
           "finite": bool(torch.isfinite(a).all()),
           "rel_l2": float((a - b).norm() / b.norm()),
           "max_abs": float((a - b).abs().max()), **call_summary(record)}
    log(f"path parity {res['mode']} {pol.compute_dtype} ({cfg.n_layers} "
        f"layers): logits kernels vs plain rel L2 {res['rel_l2']:.3e} "
        f"(bound {LOGIT_REL_L2_BOUND[pol.compute_dtype]}), max abs "
        f"{res['max_abs']:.3e}, max |logit| {float(b.abs().max()):.3f}; "
        f"flash calls {res['calls_outside']['flash_attention']}/"
        f"{res['calls']['flash_attention']} outside {TOL[pol.compute_dtype]}"
        f", max err {res['call_max_err']['flash_attention']:.3e}, max rel "
        f"L2 {res['call_max_rel']['flash_attention']:.3e}")
    return res


def gemma_continuous_run(ops, sched_mod, cfg, params, pol) -> dict:
    """``ContinuousScheduler`` in contiguous mode: batch 4, bucket 4096
    (the window), 8 requests of 600-4096 tokens and 4-16 new tokens.  Every
    slot prefill launches the flash forward once a layer; ``paged``,
    ``paged_int8`` and ``prefix_cache`` are refused with ``ValueError``."""
    for kw in (dict(cache_mode="paged"), dict(cache_mode="paged_int8"),
               dict(cache_mode="paged", prefix_cache=True),
               dict(prefix_cache=True)):
        try:
            sched_mod.ContinuousScheduler(
                params, cfg, pol, batch=BATCH, max_len=GEMMA_MAX_LEN,
                prefill_len=GEMMA_BUCKET, device=DEVICE, **kw)
        except ValueError as e:
            log(f"gemma2 {kw}: refused ({e})")
        else:
            raise AssertionError(f"gemma2 {kw}: not refused")
    rng = np.random.default_rng(SEED + 8)
    sched = sched_mod.ContinuousScheduler(
        params, cfg, pol, batch=BATCH, max_len=GEMMA_MAX_LEN,
        prefill_len=GEMMA_BUCKET, cache_mode="contiguous",
        cache_dtype=torch.bfloat16, device=DEVICE)
    for rid in range(N_REQUESTS):
        n = int(rng.integers(600, GEMMA_BUCKET + 1))
        sched.submit(sched_mod.Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab_size, size=n,
                                         dtype=np.int32),
            max_new_tokens=int(rng.integers(4, 17))))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    done = sched.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st = sched.stats
    if len(done) != N_REQUESTS or any(
            r.output is None or len(r.output) == 0 for r in done):
        raise AssertionError("gemma2 continuous: not every request produced "
                             "tokens")
    if st.nonfinite_logits:
        raise AssertionError(f"gemma2 continuous: {st.nonfinite_logits} "
                             "non-finite logit rows")
    if counts["flash_fwd"] != st.prefills * cfg.n_layers or \
            counts["paged_decode"]:
        raise AssertionError(f"gemma2 continuous: launches {counts} for "
                             f"{st.prefills} prefills")
    step_ms = 1e3 * st.decode_s / max(st.decode_steps - 1, 1)
    log(f"gemma2 continuous (contiguous, bucket {GEMMA_BUCKET}, max_len "
        f"{GEMMA_MAX_LEN}): {len(done)} requests, {st.prefills} prefills, "
        f"{st.decode_steps} decode steps, {st.useful_tokens} tokens in "
        f"{st.wall_s:.3f} s ({st.tokens_per_s:.1f} tok/s), decode "
        f"{step_ms:.3f} ms/step; launches {counts}; KV cache "
        f"{st.cache_bytes / 2**30:.3f} GiB (local rings of "
        f"{cfg.sliding_window} rows)")
    return counts


def flash_window_bound(b, h, kvh, s, dh, window, item=2):
    """(bound ms, by) of the causal windowed flash forward with GQA: q and
    out (B H S Dh), k and v (B KV S Dh) read or written once, lse (fp32),
    against 4 operations per unmasked (query, key) pair and channel: query
    i sees min(i + 1, window) keys."""
    w = min(window, s)
    pairs = b * h * (w * (w + 1) // 2 + (s - w) * w)
    return bound((2 * h + 2 * kvh) * b * s * dh * item + b * h * s * 4,
                 4 * pairs * dh)


def decoder_yardsticks(ops) -> dict:
    """The two new path shapes timed: the flash forward at gemma2's prefill
    (2, 32, 8192, 128) over 16 KV heads, causal, window 4096, softcap 50,
    and paged decode at deepseek-coder-33b's group 7 (56 heads over 8, the
    serve geometry, bf16 and int8 pages).  Each held against its plain
    version first, then timed beside the plain version, one PyTorch op
    over the same bytes and an empty kernel; no single PyTorch call
    computes either (SDPA has no softcap; there is no paged call)."""
    from repro_torch.kernels import paged_attention as pa
    timer = Timer()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 30)
    dtype = torch.bfloat16
    b, h, kvh, s, dh = GEMMA_BATCH, 32, 16, GEMMA_PROMPT, 128
    q = torch.randn(b, h, s, dh, generator=gen, device=DEVICE).to(dtype)
    k, v = (torch.randn(b, kvh, s, dh, generator=gen, device=DEVICE).to(
        dtype) for _ in range(2))
    kw = dict(causal=True, window=4096, softcap=50.0)
    o, lse = ops.flash_attention(q, k, v, **kw)
    ro, rlse = ops.flash_attention(q, k, v, impl="torch", **kw)
    wide, _ = ops.flash_attention(q, k, v, causal=True, softcap=50.0)
    torch.cuda.synchronize()
    tag = f"flash {(b, h, s, dh)} over {kvh} KV heads {kw}"
    err = check_grad(tag + " out", o, ro, dtype)[0]
    check_grad(tag + " lse", lse, rlse, dtype)
    bites = rel_l2(o, wide)
    if not bites > 1e-2:
        raise AssertionError(f"{tag}: the window changes the output by "
                             f"{bites:.3e} only")
    same = torch.ones(((2 * h + 2 * kvh) * b * s * dh * 2) // 4,
                      device=DEVICE)
    res = yardstick_times(timer, lambda: ops.flash_attention(q, k, v, **kw),
                          lambda: same.sum())
    plain = timer.times(lambda: ops.flash_attention(q, k, v, impl="torch",
                                                     **kw), iters=5)
    # what the softcap's tanh a score costs: the same call without it
    nocap = timer.times(lambda: ops.flash_attention(
        q, k, v, causal=True, window=kw["window"]))
    bd = flash_window_bound(b, h, kvh, s, dh, kw["window"])
    out = {"flash_window": dict(
        err=err, ms=float(np.mean(res["times"])), plain_ms=median(plain),
        bound_ms=bd[0], bound_by=bd[1], library_ms=None)}
    log(f"{tag}: max err {err:.3e}; the window moves the output by rel L2 "
        f"{bites:.3e} against no window; kernel {spread(res['times'])}, "
        f"plain median {median(plain):.4f} ms, bound {bd[0]:.4f} ms "
        f"({bd[1]}), library none (SDPA has no softcap); without the "
        f"softcap: kernel {spread(nocap)}; "
        + yardstick_log(res, "torch.sum of the same bytes"))
    del q, k, v, o, ro, wide, same
    mp = -(-MAX_LEN // PAGE_SIZE)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    h, kvh = CODER_HEADS
    for quant in (False, True):
        lens = np.random.default_rng(500 + quant).integers(
            600, MAX_LEN + 1, size=BATCH)
        qd, kp, vp, bt, kvl, sc = paged_inputs(
            gen, lens, h=h, kvh=kvh, dh=128, mp=mp, dtype=dtype, quant=quant)
        args = (qd, kp, vp, bt, kvl)
        tag = (f"paged_decode{'_int8' if quant else ''} G 7 ({h} heads over "
               f"{kvh}) B={BATCH} split {pa.split_plan(mp, BATCH * kvh, n_sm)}")
        ops.reset_launch_counts()
        err = paged_check(ops, tag, args, sc, dtype)
        if ops.launch_counts().get("paged_decode_split") != 1:
            raise AssertionError(f"{tag}: not on the split kernel")
        first = ops.paged_decode_attention(*args, **sc)
        second = ops.paged_decode_attention(*args, **sc)
        torch.cuda.synchronize()
        check_same_bits(tag, (first,), (second,))
        nbytes = paged_bytes(lens, kp, qd, quant)
        same = torch.ones(nbytes // 4, device=DEVICE)
        res = yardstick_times(
            timer, lambda: ops.paged_decode_attention(*args, **sc),
            lambda: same.sum())
        plain = timer.times(lambda: ops.paged_decode_attention(
            *args, impl="torch", **sc))
        bd = bound(nbytes, 4 * int(lens.sum()) * h * 128, dtype)
        out[f"paged_g7{'_int8' if quant else ''}"] = dict(
            err=err, ms=float(np.mean(res["times"])), plain_ms=median(plain),
            bound_ms=bd[0], bound_by=bd[1], library_ms=None)
        log(f"{tag} (kv_len {lens.tolist()}): max err {err:.3e}, the same "
            f"bits on relaunch; kernel {spread(res['times'])}, plain median "
            f"{median(plain):.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), "
            "library none; " + yardstick_log(res, "torch.sum of the same "
                                                  "bytes"))
    return out


def decoders_phase(T, ops, serve, serve_step, sched_mod, get_config,
                   make_policy) -> dict:
    """The dense decoder variants at full width, depth cut, bf16 weights
    seeded on the card: (a) gemma2-27b's raw mode, its kernels-vs-plain
    logits and its continuous run; (b) qwen1.5-32b and (c)
    deepseek-coder-33b served in paged and paged_int8 (deepseek-7b's
    geometry) and held kernels vs plain; (d) each model's kernels-vs-plain
    hold in f32 at 2 layers; then the yardsticks of the two new shapes.
    Returns each run's launch counts and the yardsticks."""
    t_phase = time.perf_counter()
    pol, pol32 = make_policy("bf16"), make_policy("f32")
    launches = {}
    t0 = time.perf_counter()
    cfg, params = decoder_model(T, get_config, "gemma2-27b",
                                DECODER_LAYERS["gemma2-27b"], pol)
    log(f"gemma2-27b full width, {cfg.n_layers} layers: "
        f"{cfg.param_count() / 1e9:.3f} B params (bf16) made in "
        f"{time.perf_counter() - t0:.1f} s")
    launches["gemma2 raw"] = gemma_raw_run(ops, serve, cfg, params, pol)
    check_parity(gemma_parity(T, ops, cfg, params, pol, GEMMA_BATCH,
                              GEMMA_NEW))
    launches["gemma2 continuous"] = gemma_continuous_run(ops, sched_mod, cfg,
                                                         params, pol)
    del params
    torch.cuda.empty_cache()
    for arch in ("qwen1.5-32b", "deepseek-coder-33b"):
        t0 = time.perf_counter()
        cfg, params = decoder_model(T, get_config, arch,
                                    DECODER_LAYERS[arch], pol)
        log(f"{arch} full width, {cfg.n_layers} layers: "
            f"{cfg.param_count() / 1e9:.3f} B params (bf16) made in "
            f"{time.perf_counter() - t0:.1f} s; {cfg.n_heads} query heads "
            f"over {cfg.n_kv_heads} KV heads, QKV bias {cfg.qkv_bias}")
        for mode in ("paged", "paged_int8"):
            launches[f"{arch} {mode}"] = serve_run(T, ops, sched_mod, cfg,
                                                   params, pol, mode)
            torch.cuda.empty_cache()
        for mode in ("paged", "paged_int8"):
            check_parity(path_parity(T, serve_step, ops, cfg, params, pol,
                                     mode))
        del params
        torch.cuda.empty_cache()
    # (d) the same holds in f32, where only summation order separates them
    for arch in ("gemma2-27b", "qwen1.5-32b", "deepseek-coder-33b"):
        cfg, params = decoder_model(T, get_config, arch, DECODER_F32_LAYERS,
                                    pol32)
        if arch == "gemma2-27b":
            check_parity(gemma_parity(T, ops, cfg, params, pol32, 1, 4))
        else:
            for mode in ("paged", "paged_int8"):
                check_parity(path_parity(T, serve_step, ops, cfg, params,
                                         pol32, mode))
        del params
        torch.cuda.empty_cache()
    yard = decoder_yardsticks(ops)
    torch.cuda.empty_cache()
    log(f"peak device memory (dense decoder variants) "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; decoders phase "
        f"on {nvidia_smi()}: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "yardsticks": yard}

# ---------------------------------------------------------------------------
# training the dense decoder variants and RWKV-6
# ---------------------------------------------------------------------------

# each model's training path at full width, depth cut to what one card
# holds (PERF.md §4; LM_PATHS): gemma2's first (local) layer alone at 2 x
# 8192 tokens, twice its 4096-token window, so the window masks keys in
# the backward; qwen's first layer and the coder's first two (56 query
# heads over 8 on both) at the LM path's 8 x 1024; rwkv6-1.6b whole (24
# layers) at the same geometry.  LM_STEPS steps of bf16 under LAMB each.
VARIANTS = ("gemma2-27b", "qwen1.5-32b", "deepseek-coder-33b")
# the kernels-vs-plain step in f32 at the smallest depth, one layer;
# gemma2's at S 4224 (> its window, a multiple of 128): at S 8192 its f32
# logits (8 x 2.1 G elements a micro-batch, 8.4 GB each) and their
# softcap and loss would not fit beside the f32 training state
F32_LAYERS, GEMMA_F32_SEQ = 1, 4224
# rwkv's held calls: wkv6 at the fp32 tolerance with the absolute part
# scaled by the output's RMS (it computes in fp32, as the serve path holds
# it), LayerNorm forward and backward and LAMB at the call's dtype
RWKV_HELD = {"layernorm_fwd": (None, False), "layernorm_bwd": (None, False),
             "wkv6": (torch.float32, True), "lamb_moments": (None, False)}
# the flash pair's new training shapes, (B, H, KV heads, S, Dh, window,
# softcap): gemma2's micro-batch with its window and softcap, 16 KV heads
# expanded to 32; the coder's, 8 KV heads expanded to 56
GEMMA_ATTN = (1, 32, 16, 8192, 128, 4096, 50.0)
CODER_ATTN = (4, 56, 8, 1024, 128, 0, 0.0)


def train_args(arch: str, optimizer: str = "lamb") -> list:
    layers, batch, seq, accum = LM_PATHS[arch]
    return ["--arch", arch, "--full", "--layers", str(layers), "--batch",
            str(batch), "--seq", str(seq), "--accum", str(accum), "--steps",
            str(LM_STEPS), "--precision", "bf16", "--optimizer", optimizer,
            "--device", DEVICE, "--seed", str(SEED), "--log-every", "1"]


def path_cfg(train, arch: str, layers: int):
    """The CLI's model of ``arch`` at full width and ``layers`` layers."""
    return train.model_config(train.parse_args(
        ["--arch", arch, "--full", "--layers", str(layers)]))


def train_launches(arch: str, n_groups: int) -> dict:
    """The launches of LM_STEPS steps of ``arch``'s CLI run under LAMB,
    derived: per micro-batch, an attention layer's flash forward runs
    twice (once more in the backward: the layer's recompute under the
    checkpoint) and its backward once (pre-pass, main pass and, over
    S / 128 > 1 KV tiles, the post-pass); an rwkv layer's wkv6 forward
    twice (the recompute; its backward is the chunked form's VJP, no
    kernel) and its two LayerNorms twice forward and once backward, the
    final norm once each (outside the checkpoint); LAMB's kernel once a
    leaf group a step.  Nothing else launches."""
    layers, _, seq, accum = LM_PATHS[arch]
    mb = accum * LM_STEPS
    if arch == "rwkv6-1.6b":
        want = {"wkv6": 2 * layers * mb, "layernorm": (4 * layers + 1) * mb,
                "layernorm_bwd": (2 * layers + 1) * mb}
    else:
        want = {"flash_fwd": 2 * layers * mb,
                f"flash_fwd_s{seq}": 2 * layers * mb}
        for k in ("flash_bwd_prep", "flash_bwd", "flash_bwd_post",
                  f"flash_bwd_s{seq}"):
            want[k] = layers * mb
    want["lamb_moments"] = n_groups * LM_STEPS
    return want


def model_train_run(ops, train, arch: str) -> dict:
    """``launch/train.py`` on ``arch``'s training path under LAMB, launch
    counts zeroed just before and read just after: every step finite and
    taken, the launches exactly ``train_launches``.  Returns the counts,
    the history, the peak memory, the seconds and the config."""
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, state, history = train.run(train_args(arch))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_groups = len(state.opt.groups.paths)
    n_params = sum(t.numel() for t in state.opt.master.values())
    del state
    torch.cuda.empty_cache()
    for r in history:
        log(f"{arch} train step {r['step']:.0f}: loss {r['loss']:.4f} "
            f"({r['loss'].hex()}), grad norm {r['grad_norm']:.4f}, lr "
            f"{r['lr']:.3g}, skipped {bool(r['skipped'])}, {r['ms']:.1f} ms")
    if [r["step"] for r in history] != list(range(1, LM_STEPS + 1)) or any(
            r["skipped"] or not np.isfinite(r["loss"]) for r in history):
        raise AssertionError(f"{arch} train: expected {LM_STEPS} finite "
                             f"steps, got {history}")
    want = train_launches(arch, n_groups)
    got = {k: n for k, n in counts.items() if n}
    if got != want:
        raise AssertionError(f"{arch} train: launches {got}, expected "
                             f"{want}")
    layers, batch, seq, accum = LM_PATHS[arch]
    steps_ms = [r["ms"] for r in history]
    log(f"{arch} train full width: {cfg.n_layers} layers "
        f"{[m for m, _ in cfg.layer_kinds()]}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} query heads over {cfg.n_kv_heads} KV heads, "
        f"{n_params / 1e9:.4f} B parameters in {n_groups} leaf groups; "
        f"{batch} x {seq} tokens a step in {accum} micro-batches; step ms "
        f"{[round(m, 1) for m in steps_ms]} (the first with the first "
        f"calls' set-up); launches {got}; peak device memory {peak:.2f} "
        f"GiB; {run_s:.1f} s (init included) on {nvidia_smi()}")
    return {"counts": counts, "history": history, "peak_gib": peak,
            "s": run_s, "cfg": cfg, "params": n_params}


def window_pairs(b, h, s, window):
    """The unmasked (query, key) pairs of causal attention with a window:
    query i sees min(i + 1, window) keys (every key without a window)."""
    w = min(window or s, s)
    return b * h * (w * (w + 1) // 2 + (s - w) * w)


def flash_fwd_window_bound(b, h, s, dh, window, item=2):
    """(bound ms, by) of the causal windowed flash forward: as
    ``flash_fwd_bound``, over ``window_pairs``."""
    return bound(4 * b * h * s * dh * item + b * h * s * 4,
                 4 * window_pairs(b, h, s, window) * dh)


def flash_bwd_window_bound(b, h, s, dh, window, item=2):
    """(bound ms, by) of the causal windowed flash backward: 8 activations
    of B H S Dh read or written once plus lse (fp32), against 10
    operations per unmasked (query, key) pair and channel."""
    return bound(8 * b * h * s * dh * item + b * h * s * 4,
                 10 * window_pairs(b, h, s, window) * dh)


def train_flash(ops, fa, timer) -> dict:
    """(c) and (d): the flash forward and backward at gemma2's and the
    coder's training shapes (GEMMA_ATTN, CODER_ATTN) in bf16, K and V
    expanded over the group as ``layers.chunked_attention`` expands them,
    in the model's (B, S, H, Dh) layout: each held against its plain
    version, launched twice for the same bits, then timed beside its
    bound, the plain version and, for the coder, SDPA's forward and
    backward over the same expanded heads (gemma2's softcap SDPA has
    not).  Also timed: the expansion's copy of K and V and the group sum
    of dK and dV that autograd adds, the cost a backward reading each KV
    head once would save.  Returns the entries ``flash_fwd_<model>`` and
    ``flash_bwd_<model>``."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 40)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtype = torch.bfloat16
    entries = {}
    for model, (b, h, kvh, s, dh, window, softcap) in (
            ("gemma2", GEMMA_ATTN), ("coder", CODER_ATTN)):
        name = f"flash_bwd_{model}"
        g = h // kvh
        kw = dict(causal=True, window=window, softcap=softcap)
        t = lambda x: x.transpose(1, 2)
        q, do = (torch.randn((b, s, h, dh), generator=gen, device=DEVICE)
                 .to(dtype) for _ in range(2))
        kx, vx = (torch.randn((b, s, kvh, dh), generator=gen, device=DEVICE)
                  .to(dtype) for _ in range(2))

        def expand(x):
            return x[:, :, :, None].expand(b, s, kvh, g, dh).reshape(
                b, s, h, dh)
        q, do = t(q), t(do)
        k, v = t(expand(kx)), t(expand(vx))
        tag = f"{(b, h, s, dh)} ({kvh} KV heads expanded) {kw}"
        out, lse = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention(q, k, v, impl="torch", **kw)
        torch.cuda.synchronize()
        fwd = [check_grad(f"flash_fwd_{model} {tag} {n}", x, y, dtype)
               for x, y, n in zip((out, lse), want, ("out", "lse"))]
        check_same_bits(f"flash_fwd_{model} {tag}", (out, lse),
                        ops.flash_attention(q, k, v, **kw))
        del want
        fwd_t = timer.times(lambda: ops.flash_attention(q, k, v, **kw))
        fwd_plain_t = timer.times(lambda: ops.flash_attention(
            q, k, v, impl="torch", **kw), iters=3)
        fwd_lib, fwd_lib_log = None, "none (SDPA has no softcap)"
        if not softcap and not window:
            lib_t = timer.times(lambda: sdpa(q, k, v, is_causal=True))
            fwd_lib = float(np.mean(lib_t))
            fwd_lib_log = f"SDPA forward {fwd_lib:.4f} ({spread(lib_t)})"
        fb = flash_fwd_window_bound(b, h, s, dh, window)
        fwd_ms = float(np.mean(fwd_t))
        entries[f"flash_fwd_{model}"] = entry(
            f"flash_fwd_{model}", "flash_fwd.cu", "flash_attention.py:132",
            max(e for e, _ in fwd), fwd_ms, median(fwd_plain_t), *fb,
            fwd_lib)
        log(f"flash_fwd_{model} {tag}: max err "
            f"{max(e for e, _ in fwd):.3e} (rel L2 "
            f"{max(r for _, r in fwd):.3e}), two launches the same bits; "
            f"kernel {fwd_ms:.4f} ms ({spread(fwd_t)}), bound {fb[0]:.4f} "
            f"ms ({fb[1]}), plain median {median(fwd_plain_t):.4f} ms, "
            f"library {fwd_lib_log} on {nvidia_smi()}")
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        want = ops.flash_attention_bwd(q, k, v, out, lse, do, impl="torch",
                                       **kw)
        torch.cuda.synchronize()
        tag = f"{name} {tag}"
        held = [check_grad(f"{tag} d{n}", x, y, dtype)
                for x, y, n in zip(got, want, "qkv")]
        check_same_bits(tag, got, fa.flash_attention_bwd(q, k, v, out, lse,
                                                         do, **kw))
        del want
        bwd_t = timer.times(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, **kw))
        plain_t = timer.times(lambda: ops.flash_attention_bwd(
            q, k, v, out, lse, do, impl="torch", **kw), iters=3)
        expand_t = timer.times(lambda: (expand(kx), expand(vx)))
        dk_model = t(got[1])
        sum_t = timer.times(lambda: (
            dk_model.reshape(b, s, kvh, g, dh).sum(3),
            dk_model.reshape(b, s, kvh, g, dh).sum(3)))
        lib_ms, lib_log = None, "none (SDPA has no softcap)"
        if not softcap and not window:
            qg, kg, vg = (x.detach().clone().requires_grad_()
                          for x in (q, k, v))
            sdpa_out = sdpa(qg, kg, vg, is_causal=True)
            lib_t = timer.times(lambda: torch.autograd.grad(
                sdpa_out, (qg, kg, vg), do, retain_graph=True))
            lib_ms = float(np.mean(lib_t))
            lib_log = f"SDPA backward {lib_ms:.4f} ({spread(lib_t)})"
            del sdpa_out, qg, kg, vg
        bd = flash_bwd_window_bound(b, h, s, dh, window)
        ms = float(np.mean(bwd_t))
        entries[name] = entry(name, "flash_bwd.cu", "flash_attention.py:272",
                              max(e for e, _ in held), ms,
                              median(plain_t), *bd, lib_ms)
        log(f"{tag}: max err {max(e for e, _ in held):.3e} (rel L2 "
            f"{max(r for _, r in held):.3e}), two launches the same bits; "
            f"kernel {ms:.4f} ms ({spread(bwd_t)}), bound {bd[0]:.4f} ms "
            f"({bd[1]}), plain median {median(plain_t):.4f} ms, library "
            f"{lib_log}; the GQA expansion's copy of K and V "
            f"{median(expand_t):.4f} ms and the group sum of dK and dV "
            f"{median(sum_t):.4f} ms (medians) on {nvidia_smi()}")
        del q, k, v, do, kx, vx, out, lse, got, dk_model
        torch.cuda.empty_cache()
    return entries


def coder_step_bits(api, ts, TrainConfig, make_policy, lm_batches,
                    cfg) -> None:
    """(c): two gradient steps of the coder (bf16, its training path's
    first batch) from one state: every gradient group the same bits, the
    attention's K and V groups (the group sum of the expansion) among
    them."""
    pol = make_policy("bf16")
    _, batch_n, seq, accum = LM_PATHS["deepseek-coder-33b"]
    tcfg = TrainConfig(precision="bf16", accum_steps=accum,
                       optimizer="lamb")
    state = ts.init_train_state(
        api.init_params(cfg, seed=SEED + 2, device=DEVICE), pol, tcfg,
        cfg=cfg)
    batch = api.to_device(next(lm_batches(SEED, cfg.vocab_size, batch_n,
                                          seq)), DEVICE)
    grads = []
    for _ in range(2):
        grads.append(ts.step_gradients(state, batch, cfg=cfg, tcfg=tcfg,
                                       policy=pol)[1])
        torch.cuda.synchronize()
    differ = [".".join(p) for p in grads[0]
              if not same_bits(grads[0][p], grads[1][p])]
    log(f"deepseek-coder-33b ({cfg.n_layers} layers): two gradient steps "
        f"from one state, {len(grads[0])} groups, {len(differ)} differ in "
        f"any bit ({differ})")
    del grads, state
    torch.cuda.empty_cache()
    if differ:
        raise AssertionError(f"coder: gradient groups {differ} differ "
                             "between two steps from one state")


def variants_train_phase(ops, fa, train, api, ts, TrainConfig, make_policy,
                         lm_batches) -> dict:
    """The dense variants' training at full width, depth cut (LM_PATHS):
    for each model (a) the CLI under LAMB (``model_train_run``), (b) one
    LAMB step kernels vs plain in bf16 at its path and in f32 at one layer,
    every flash and LAMB call held, within LM_BOUND (qwen's QKV biases
    drawn at QKV_BIAS_STD); the coder's (c) two gradient steps in the same
    bits; then (c) and (d) the flash forward and backward at the two new
    shapes.
    Returns the kernel entries and the runs."""
    t_phase = time.perf_counter()
    runs = {}
    for arch in VARIANTS:
        t0 = time.perf_counter()
        runs[arch] = model_train_run(ops, train, arch)
        _, batch_n, seq, accum = LM_PATHS[arch]
        cfg = runs[arch]["cfg"]
        prepare = draw_biases if cfg.qkv_bias else None
        check_train_parity(lm_train_parity(
            ops, api, ts, TrainConfig, make_policy, lm_batches, cfg, "bf16",
            geometry=(batch_n, seq, accum), prepare=prepare, tag=arch),
            LM_BOUND, arch)
        torch.cuda.empty_cache()
        seq32 = GEMMA_F32_SEQ if arch == "gemma2-27b" else seq
        check_train_parity(lm_train_parity(
            ops, api, ts, TrainConfig, make_policy, lm_batches,
            path_cfg(train, arch, F32_LAYERS), "f32",
            geometry=(batch_n, seq32, accum), prepare=prepare, tag=arch),
            LM_BOUND, arch)
        torch.cuda.empty_cache()
        if arch == "deepseek-coder-33b":
            coder_step_bits(api, ts, TrainConfig, make_policy, lm_batches,
                            cfg)
        log(f"{arch} training: {time.perf_counter() - t0:.1f} s")
    timer = Timer()
    entries = train_flash(ops, fa, timer)
    del timer
    torch.cuda.empty_cache()
    log(f"variants training phase on {nvidia_smi()}: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"entries": entries, "runs": runs}


def wkv6_train_times(ops, timer) -> dict:
    """(e): the wkv6 forward at rwkv's training shape (LM_BATCH / LM_ACCUM
    x LM_SEQ, 32 heads of 64; bf16 r, k, v as the bf16 step gives them),
    held against its plain version, timed beside its bound and the plain
    version; and the VJP of the chunked form (``kops.wkv6_vjp``'s
    backward: the chunked form run again under autograd and
    differentiated) at the same shape, the time a backward kernel would
    replace."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 50)
    shape = (LM_BATCH // LM_ACCUM, LM_SEQ, 32, 64)
    args = wkv6_inputs(gen, *shape, dtype=torch.bfloat16)
    err = wkv6_check(ops, f"wkv6 training shape {shape}", args, WKV_CHUNK,
                     relaunch=True)
    times = timer.times(lambda: ops.wkv6(*args, chunk=WKV_CHUNK))
    plain = timer.times(lambda: ops.wkv6(*args, chunk=WKV_CHUNK,
                                         impl="torch"), iters=5)
    bd = wkv6_bound(args[0], args[4], WKV_CHUNK)[:2]
    ins = [t.detach().clone().requires_grad_(i < 5)
           for i, t in enumerate(args)]
    o, _ = ops.wkv6_vjp(*ins, chunk=WKV_CHUNK)
    do = torch.randn(o.shape, generator=gen, device=DEVICE)
    vjp_t = timer.times(lambda: torch.autograd.grad(
        o, ins[:5], do, retain_graph=True), iters=5)
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(o, ins[:5], do, retain_graph=True)
    vjp_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = float(np.mean(times))
    log(f"wkv6 training shape {shape} bf16 r/k/v: max err {err:.3e}, the "
        f"same bits on relaunch; kernel {ms:.4f} ms ({spread(times)}), "
        f"bound {bd[0]:.4f} ms ({bd[1]}), plain median {median(plain):.4f} "
        f"ms; its backward, the chunked form's VJP (plain PyTorch, no "
        f"kernel): median {median(vjp_t):.4f} ms ({spread(vjp_t)}), peak "
        f"device memory {vjp_peak:.2f} GiB during it")
    del ins, o, do, args
    torch.cuda.empty_cache()
    return {"entry": entry("wkv6_train", "wkv6.cu", "wkv6.py:98", err, ms,
                           median(plain), *bd, None),
            "vjp_ms": median(vjp_t)}


def rwkv_train_phase(ops, train, api, ts, TrainConfig, make_policy,
                     lm_batches) -> dict:
    """rwkv6-1.6b's training at full width and depth (LM_PATHS): (a)
    the CLI under LAMB (``model_train_run``: wkv6 forward, LayerNorm and
    its backward, LAMB); (b) one LAMB step kernels vs plain in bf16 and in
    f32 at one layer (the bf16 step beside plain f32: the note below
    LM_BOUND), every wkv6, LayerNorm and LAMB call
    held (wkv6's also within WKV_TOL relative L2), within LM_BOUND; (e) the
    wkv6 forward and its VJP timed at the training shape.  Returns the
    kernel entry and the run."""
    t_phase = time.perf_counter()
    arch = "rwkv6-1.6b"
    run = model_train_run(ops, train, arch)
    _, batch_n, seq, accum = LM_PATHS[arch]
    cfg = path_cfg(train, arch, F32_LAYERS)
    for precision in ("bf16", "f32"):
        res = lm_train_parity(ops, api, ts, TrainConfig, make_policy,
                              lm_batches, cfg, precision,
                              geometry=(batch_n, seq, accum), held=RWKV_HELD,
                              tag=arch, floor=precision != "f32")
        check_train_parity(res, LM_BOUND, arch)
        if not res["call_max_rel"]["wkv6"] <= WKV_TOL:
            raise AssertionError(f"{arch} parity {precision}: a wkv6 call "
                                 f"departs from the plain version (rel L2 "
                                 f"{res['call_max_rel']['wkv6']:.3e})")
        torch.cuda.empty_cache()
    timer = Timer()
    wkv = wkv6_train_times(ops, timer)
    del timer
    torch.cuda.empty_cache()
    log(f"rwkv training phase on {nvidia_smi()}: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"entry": wkv["entry"], "run": run}


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    only = args[1] if len(args) == 2 and args[0] == "--only" else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.amp import make_policy
    from repro_torch.data.pipeline import ShardedLoader, lm_batches
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import pretrain_bert
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    from repro_torch.serve import scheduler as sched_mod
    from repro_torch.serve import serve_step
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import latest_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the serve CLI's own lines (prefill and decode times of the raw mode)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("serve: %(message)s"))
    logging.getLogger("repro_torch.serve").addHandler(handler)
    logging.getLogger("repro_torch.serve").setLevel(logging.INFO)
    log(nvidia_smi())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = build.build_all()
    for name, r in report.items():
        (build.BUILD_DIR / f"{name}.log").write_text(r["log"])
    log(f"built {sorted(report) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")

    bert = get_config("bert-large")
    # the largest LAMB leaf group: blocks.mlp.wi (and .wo), 24 x 1024 x 4096
    largest = bert.n_layers * bert.d_model * bert.d_ff
    timer = Timer()
    if only == "layernorm":
        layernorm_phase(ops, timer)
        layernorm_bwd_phase(ops, timer)
        log("LayerNorm phases only: no other phase, no result")
        return 2
    if only == "wkv6":
        wkv6_phase(ops, timer)
        log("wkv6 phase only: no other phase, no result")
        return 2
    if only == "resume":
        resume_phase(latest_step)
        log("resume phase only: no other phase, no result")
        return 2
    if only == "lm":
        lm_phase(ops, fa)
        log("decoder-LM phase only: no other phase, no result")
        return 2
    if only == "dp":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_bert_") as tmp:
            _, losses = train_run(ops, pretrain_bert, Path(tmp) / "bf16",
                                  "bf16")
        torch.cuda.empty_cache()
        dp_phase(losses)
        log("data-parallel phase only: no other phase, no result")
        return 2
    if only == "serve":
        del timer
        deepseek_serve_phase(T, ops, serve_step, sched_mod, get_config,
                             make_policy)
        log("deepseek serve phase only: no other phase, no result")
        return 2
    if only == "decoders":
        del timer
        decoders_phase(T, ops, serve_cli, serve_step, sched_mod, get_config,
                       make_policy)
        log("dense decoder variants phase only: no other phase, no result")
        return 2
    train_mods = (train_cli, api, ts, TrainConfig, make_policy, lm_batches)
    if only == "variants_train":
        del timer
        variants_train_phase(ops, fa, *train_mods)
        log("variants training phase only: no other phase, no result")
        return 2
    if only == "rwkv_train":
        del timer
        rwkv_train_phase(ops, *train_mods)
        log("rwkv training phase only: no other phase, no result")
        return 2
    entries = [flash_phase(ops, timer)] + paged_phase(ops, timer)
    train_entries = flash_bwd_phase(ops, fa, timer)
    train_entries["layernorm"] = layernorm_phase(ops, timer)
    train_entries["layernorm_bwd"] = layernorm_bwd_phase(ops, timer)
    train_entries["bias_gelu"] = bias_gelu_phase(ops, timer)
    train_entries["bias_gelu_bwd"] = bias_gelu_bwd_phase(ops, timer)
    train_entries["lamb_moments"] = lamb_phase(ops, timer, largest)
    entries += [train_entries[k] for k in (
        "flash_fwd_phase1", "flash_fwd_phase2", "flash_bwd_phase1",
        "flash_bwd_phase2", "layernorm", "layernorm_bwd", "bias_gelu",
        "bias_gelu_bwd", "lamb_moments")]
    entries.append(wkv6_phase(ops, timer))
    del timer
    torch.cuda.empty_cache()
    if only == "kernels":
        log("kernel phases only: no serve or training phase, no result")
        return 2

    launches = deepseek_serve_phase(T, ops, serve_step, sched_mod,
                                    get_config, make_policy)
    torch.cuda.reset_peak_memory_stats()
    decoders = decoders_phase(T, ops, serve_cli, serve_step, sched_mod,
                              get_config, make_policy)

    torch.cuda.reset_peak_memory_stats()
    launches.update(rwkv_phases(T, ops, serve_cli, sched_mod, get_config,
                                make_policy))
    log(f"peak device memory (rwkv serving) "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bert_") as tmp:
        workdir = Path(tmp)
        launches["train"], bf16_losses = train_run(
            ops, pretrain_bert, workdir / "bf16", "bf16")
        torch.cuda.empty_cache()
        launches["train_f16"], _ = train_run(ops, pretrain_bert,
                                             workdir / "f16", "f16")
        torch.cuda.empty_cache()
        for precision in ("f32", "bf16", "f16"):
            check_train_parity(train_parity(
                ops, api, ts, TrainConfig, ShardedLoader, make_policy, bert,
                workdir / "bf16", precision))
            torch.cuda.empty_cache()
    hold_inputs = bwd_hold_inputs(api, ts, TrainConfig, InputShape,
                                  make_policy, bert)
    check_calls("phase-2 backward hold", bwd_hold(ops, ts, bert,
                                                  *hold_inputs))
    step_determinism(ts, bert, *hold_inputs)
    del hold_inputs
    torch.cuda.empty_cache()
    resume_phase(latest_step)
    dp_phase(bf16_losses)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = lm_phase(ops, fa)
    entries += [lm["entries"][k] for k in ("flash_fwd_lm", "flash_bwd_lm",
                                           "lamb_moments_lm")]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    vtrain = variants_train_phase(ops, fa, *train_mods)
    entries += [vtrain["entries"][f"flash_{kind}_{model}"]
                for model in ("gemma2", "coder") for kind in ("fwd", "bwd")]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rtrain = rwkv_train_phase(ops, *train_mods)
    entries.append(rtrain["entry"])

    serve_runs = ("paged", "paged_int8", "prefix_paged", "prefix_paged_int8",
                  "prefix_unshared", "cohort")
    dec = decoders["launches"]
    by_name = {
        "flash_fwd": sum(launches[r]["flash_fwd"] for r in serve_runs)
        + launches["train"]["flash_fwd"]
        + sum(c["flash_fwd"] for c in dec.values()),
        "paged_decode": sum(launches[r]["paged_decode"] for r in (
            "paged", "prefix_paged", "prefix_unshared"))
        + sum(c["paged_decode"] for r, c in dec.items()
              if r.endswith(" paged")),
        "paged_decode_int8": launches["paged_int8"]["paged_decode"]
        + launches["prefix_paged_int8"]["paged_decode"]
        + sum(c["paged_decode"] for r, c in dec.items()
              if r.endswith(" paged_int8")),
    }
    by_name.update({k: launches["train"][k] for k in TRAIN_KERNELS[1:]})
    for phase, (_, _, s, _) in enumerate(TRAIN_ATTN, start=1):
        for kind in ("fwd", "bwd"):
            by_name[f"flash_{kind}_phase{phase}"] = launches["train"][
                f"flash_{kind}_s{s}"]
    by_name["layernorm"] += (launches["rwkv_raw"]["layernorm"]
                             + launches["rwkv_continuous"]["layernorm"])
    by_name["wkv6"] = (launches["rwkv_raw"]["wkv6"]
                       + launches["rwkv_continuous"]["wkv6"])
    lm_runs = [r["counts"] for r in lm["runs"].values()]
    by_name["flash_fwd_lm"] = sum(c[f"flash_fwd_s{LM_SEQ}"] for c in lm_runs)
    by_name["flash_bwd_lm"] = sum(c[f"flash_bwd_s{LM_SEQ}"] for c in lm_runs)
    by_name["lamb_moments_lm"] = lm["runs"]["lamb"]["counts"]["lamb_moments"]
    # the training runs of steps 12 and 13: qwen's flash forward and
    # backward at S 1024, Dh 128 (MHA, 40 heads) beside the LM's, gemma2's
    # (S 8192, windowed, softcapped) and the coder's (56 expanded heads)
    # on the rows timed at their shapes, rwkv's LayerNorms with the rest,
    # every decoder LAMB launch on the LM's row
    vt_runs = {a: r["counts"] for a, r in vtrain["runs"].items()}
    rt_run = rtrain["run"]["counts"]
    for kind in ("fwd", "bwd"):
        by_name[f"flash_{kind}_lm"] += vt_runs["qwen1.5-32b"][f"flash_{kind}"]
        for model, arch in (("gemma2", "gemma2-27b"),
                            ("coder", "deepseek-coder-33b")):
            by_name[f"flash_{kind}_{model}"] = vt_runs[arch][f"flash_{kind}"]
    by_name["lamb_moments_lm"] += sum(
        c["lamb_moments"] for c in [*vt_runs.values(), rt_run])
    for k in ("layernorm", "layernorm_bwd"):
        by_name[k] += rt_run[k]
    by_name["wkv6_train"] = rt_run["wkv6"]
    log("flash_fwd launches: serve " + " + ".join(
        f"{launches[r]['flash_fwd']} ({r})" for r in serve_runs)
        + f", train {launches['train']['flash_fwd']}, dense decoder "
        "variants " + " + ".join(f"{c['flash_fwd']} ({r})"
                                 for r, c in dec.items()))
    log("paged_decode launches of the dense decoder variants: " + ", ".join(
        f"{c['paged_decode']} ({r})" for r, c in dec.items()
        if "paged" in r))
    for e in entries:
        e["launches"] = by_name[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
