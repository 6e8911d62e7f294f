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
   decode with page_size 16 over f32, bf16 and int8 pages, H/KV 1, 2, 4
   and 8, at B = 5 and B = 8 with one empty slot and one slot whose table
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
   paths must agree within the bound stated for each dtype.
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
   (32, 64)} plus chunks of 6 and 60 rows, f32 and bf16 inputs, inputs
   read through strides, and the strong-decay case (logw = -50), within
   rtol = atol = 1e-4 and relative L2 1e-4; then timed at the raw
   prefill's shape (4, 1024, 32, 64) bf16 beside the plain version and
   the bound (no single PyTorch call computes it).
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
9. Prints one JSON line of kernel results, then, as the last line,
   ``{"ok": true, "device": {...}}``.

``--only kernels`` stops after the kernel phases (a quick check of a new
kernel), ``--only layernorm`` after the build and the two LayerNorm phases
(exit 2, no result line either way); without arguments everything runs.

Any failure raises and exits non-zero; without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
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
               (1, 8, 2, 130, 128, True), (1, 4, 2, 17, 64, True),
               (1, 4, 4, 17, 128, False))


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
    # small cases: GQA groups (H/KV 2, 4, 8 and 1), f32 and bf16, float and
    # int8 pages
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for quant in (False, True):
            for (h, kvh, dh) in ((8, 4, 64), (8, 2, 128), (16, 2, 64),
                                 (4, 4, 128), (4, 4, 64)):
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


# the wkv6 path shape: the full-width raw prefill, batch 4 x 1024 tokens,
# 32 heads of 64, chunks of 64
WKV_PATH = (BATCH, PREFILL_LEN, 32, 64)
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


def wkv6_check(ops, tag, args, chunk) -> float:
    """Kernel against plain on ``args`` within WKV_TOL (elementwise and
    relative L2) for o and s_final; returns the max abs error."""
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
    return max(errs)


def wkv6_bound(r, u, chunk):
    """(bound ms, by, operations, exponentials) of one launch on these
    inputs.  Bytes: r, k, v and u in their dtypes, logw and o in fp32, s0
    and s_final.  Operations per (b, h, chunk of L): the lower-triangle
    scores (sub, two multiplies, add per (i, j < i, c)), the bonus, the
    scores times V over the L (L + 1) / 2 pairs j <= i (the bonus sits on
    the diagonal), the two L x hs x hs products (r with the carried state,
    the decayed k with V), the cumsum and the decay folds, the state's
    decay (one multiply per element; its add is the product's), and one
    per exponential; at the fp32 peak."""
    b, s, h, hs = r.shape
    el = r.numel()
    nbytes = 3 * el * r.element_size() + 2 * el * 4 \
        + h * hs * u.element_size() + 2 * b * h * hs * hs * 4
    nl = chunk
    pairs = nl * (nl - 1) // 2
    exps = pairs * hs + 2 * nl * hs + hs
    flops = 4 * pairs * hs + 3 * nl * hs + 2 * (pairs + nl) * hs \
        + 2 * 2 * nl * hs * hs + 5 * nl * hs + hs * hs
    n = b * h * (s // nl)
    ms, by = bound(nbytes, n * (flops + exps), torch.float32)
    return ms, by, n * (flops + exps), n * exps


def wkv6_phase(ops, timer):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    cases = 0
    # the CPU tests' cases, a chunk of L % 4 != 0 rows, bf16 inputs, and
    # inputs read through strides (views of a wider activation)
    for s, chunk in ((128, 32), (256, 64), (64, 64), (32, 64), (6, 64),
                     (60, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            args = wkv6_inputs(gen, 2, s, 2, dtype=dtype)
            wkv6_check(ops, f"wkv6 {dtype} s={s} chunk={chunk}", args, chunk)
            cases += 1
    wide = torch.randn(2, 128, 3, 2, 64, generator=gen, device=DEVICE)
    args = wkv6_inputs(gen, 2, 128, 2)
    args = (wide[:, :, 0], wide[:, :, 1], wide[:, :, 2]) + args[3:]
    wkv6_check(ops, "wkv6 strided r, k, v", args, 64)
    # strong decay (tests/test_kernels.py:166): logw = -50 everywhere
    b, s, h, hs = 1, 64, 1, 64
    one = torch.ones(b, s, h, hs, device=DEVICE)
    wkv6_check(ops, "wkv6 strong decay", (
        one, one, one, torch.full_like(one, -50.0),
        torch.zeros(h, hs, device=DEVICE),
        torch.zeros(b, h, hs, hs, device=DEVICE)), 16)
    cases += 2
    log(f"wkv6 small cases: {cases} agree with the plain version "
        f"(rtol = atol = rel L2 = {WKV_TOL})")

    args = wkv6_inputs(gen, *WKV_PATH, dtype=torch.bfloat16)
    err = wkv6_check(ops, f"wkv6 path shape {WKV_PATH}", args, WKV_CHUNK)
    times = timer.times(lambda: ops.wkv6(*args, chunk=WKV_CHUNK))
    ms = float(np.mean(times))
    plain_ms = timer.ms(lambda: ops.wkv6(*args, chunk=WKV_CHUNK,
                                         impl="torch"), iters=5)
    bd_ms, by, n_ops, n_exp = wkv6_bound(args[0], args[4], WKV_CHUNK)
    log(f"wkv6 {WKV_PATH} bf16 r/k/v, chunk {WKV_CHUNK}: max err {err:.3e}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bd_ms:.4f} ms "
        f"({by}: {n_ops / 1e9:.3f} G operations, of which {n_exp / 1e9:.3f} "
        f"G exponentials), no single PyTorch call; kernel {spread(times)}")
    return entry("wkv6", "wkv6.cu", "wkv6.py:98", err, ms, plain_ms, bd_ms,
                 by, None)


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
    cancel."""
    saved = {name: getattr(ops, name) for name in spec}

    def held(name, fn):
        dtype, by_rms = spec[name]

        def call(*args, impl=None, **kw):
            got = fn(*args, impl=impl, **kw)
            if impl is None:
                kw.pop("out", None)
                want = fn(*args, impl="torch", **kw)
                tol = TOL[dtype or args[0].dtype]
                pairs = list(zip(got, want)) if isinstance(got, tuple) \
                    else [(got, want)]     # tuples: e.g. flash's (out, lse)
                rms = [float(w.float().square().mean().sqrt())
                       for _, w in pairs]
                errs = [compare(g, w, tol, sc if by_rms else 1.0)
                        for (g, w), sc in zip(pairs, rms)]
                record[name].append(Call(
                    max(e for e, _ in errs), all(ok for _, ok in errs),
                    max(rel_l2(g, w) for g, w in pairs), max(rms)))
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
        for shape in ((64, 128), (33, 256), (256, 1024), (2, 17, 256),
                      (7, 512), (20, 2048 if dtype != torch.float32 else 1024)):
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


def lamb_phase(ops, timer, n_path):
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
    return entry("lamb_moments", "lamb_update.cu", "lamb_update.py:49", err,
                 ms, plain_ms, *bd, None)


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
    one's count.  Every loss must be finite; in f16 a step may be skipped
    (an overflow under the loss scale, which then backs off), in bf16
    none."""
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
            f"{r['skipped']}, {r['ms']:.1f} ms")
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
    return counts


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
        state = ts.init_train_state(params, pol, tcfg)
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
        api.init_params(cfg, seed=SEED, device=DEVICE), pol, tcfg)
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


def check_train_parity(res: dict) -> None:
    tag, bd = f"train parity {res['dtype']}", TRAIN_BOUND[res["dtype"]]
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


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    only = args[1] if len(args) == 2 and args[0] == "--only" else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.amp import make_policy
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import pretrain_bert
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    from repro_torch.serve import scheduler as sched_mod
    from repro_torch.serve import serve_step
    from repro_torch.train import train_step as ts

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
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    torch.cuda.reset_peak_memory_stats()
    launches.update(rwkv_phases(T, ops, serve_cli, sched_mod, get_config,
                                make_policy))
    log(f"peak device memory (rwkv serving) "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bert_") as tmp:
        workdir = Path(tmp)
        launches["train"] = train_run(ops, pretrain_bert, workdir / "bf16",
                                      "bf16")
        torch.cuda.empty_cache()
        launches["train_f16"] = train_run(ops, pretrain_bert,
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

    by_name = {
        "flash_fwd": launches["paged"]["flash_fwd"]
        + launches["paged_int8"]["flash_fwd"] + launches["train"]["flash_fwd"],
        "paged_decode": launches["paged"]["paged_decode"],
        "paged_decode_int8": launches["paged_int8"]["paged_decode"],
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
    log(f"flash_fwd launches: serve {launches['paged']['flash_fwd']} + "
        f"{launches['paged_int8']['flash_fwd']}, train "
        f"{launches['train']['flash_fwd']}")
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
