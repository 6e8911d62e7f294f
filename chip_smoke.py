#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

  python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of ``src/repro_torch/csrc/`` (one nvcc per
   source, all at once).
3. Kernel phase: holds each kernel against its plain PyTorch version on the
   card -- flash forward at the prefill shape (1, 32, 1024, 128) bf16 causal
   plus small causal x window x softcap x GQA cases (out and lse); paged
   decode at B = 8, page_size 16, bf16 and int8 pages, with one empty slot
   and one slot whose table points at the trash page, and at the serve
   phase's geometry (B = 4 live slots of 600-1040 tokens, disjoint tables).
   Tolerance: 3e-2 for bf16, 2e-4 for f32.  Times the path shapes (paged:
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
5. Prints one JSON line of kernel results, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}
SEED = 0
DEVICE = "cuda"

# full-width serve geometry
BATCH, PREFILL_LEN, MAX_LEN, PAGE_SIZE = 4, 1024, 1040, 16
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
    cache flushed (a 256 MB write) before every one."""

    def __init__(self):
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                 device=DEVICE)

    def times(self, fn, iters: int = 20) -> list:
        """ms of each of ``iters`` launches after one warm-up launch."""
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(iters):
            self.flush.zero_()
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


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def compare(got, want, dtype):
    """(max abs error, |got - want| <= tol + tol * |want| everywhere) with
    rtol = atol = TOL[dtype]."""
    tol = TOL[dtype]
    g, w = got.float(), want.float()
    return max_err(g, w), bool(((g - w).abs() <= tol + tol * w.abs()).all())


def check_close(name: str, got, want, dtype) -> float:
    """Raise unless ``got`` is within TOL[dtype] of ``want``; returns the
    max abs error."""
    err, ok = compare(got, want, dtype)
    if not ok:
        raise AssertionError(f"{name}: outside rtol = atol = {TOL[dtype]} "
                             f"(max abs err {err:.3e})")
    return err


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def flash_phase(ops, timer):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=DEVICE,
                           dtype=torch.float32).to(dtype)

    # small cases: causal x window x softcap x GQA, ragged lengths
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for (b, h, kv, s, dh) in ((2, 4, 2, 256, 64), (1, 8, 8, 200, 128),
                                  (1, 4, 1, 130, 32)):
            for causal in (True, False):
                for window, softcap in ((0, 0.0), (64, 0.0), (0, 30.0),
                                        (64, 30.0)):
                    q = rand(b, h, s, dh, dtype=dtype)
                    k = rand(b, kv, s, dh, dtype=dtype)
                    v = rand(b, kv, s, dh, dtype=dtype)
                    kw = dict(causal=causal, window=window, softcap=softcap)
                    o, lse = ops.flash_attention(q, k, v, **kw)
                    ro, rlse = ops.flash_attention(q, k, v, impl="torch", **kw)
                    torch.cuda.synchronize()
                    tag = (f"flash {dtype} {(b, h, kv, s, dh)} causal={causal}"
                           f" window={window} softcap={softcap}")
                    check_close(tag + " out", o, ro, dtype)
                    check_close(tag + " lse", lse, rlse, dtype)
                    cases += 1
    log(f"flash small cases: {cases} agree with the plain version")

    # the prefill shape of the serve path
    b, h, s, dh = 1, 32, PREFILL_LEN, 128
    dtype = torch.bfloat16
    q, k, v = (rand(b, h, s, dh, dtype=dtype) for _ in range(3))
    o, lse = ops.flash_attention(q, k, v, causal=True)
    ro, rlse = ops.flash_attention(q, k, v, causal=True, impl="torch")
    torch.cuda.synchronize()
    err = check_close("flash path-shape out", o, ro, dtype)
    check_close("flash path-shape lse", lse, rlse, dtype)
    times = timer.times(lambda: ops.flash_attention(q, k, v, causal=True))
    ms = float(np.mean(times))
    plain_ms = timer.ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                    impl="torch"))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer.ms(lambda: sdpa(q, k, v, is_causal=True))
    item = q.element_size()
    nbytes = 4 * q.numel() * item + lse.numel() * 4   # q, k, v, out, lse
    flops = 4 * b * h * dh * (s * (s + 1) // 2)       # unmasked pairs only
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    log(f"flash (1, 32, {s}, 128) bf16 causal: max err {err:.3e}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}); "
        f"kernel {spread(times)}")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:132",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}


def edge_lens(seed: int, b: int, mp: int) -> np.ndarray:
    """Random kv_len in [1, mp * PAGE_SIZE], slot 0 empty."""
    lens = np.random.default_rng(seed).integers(1, mp * PAGE_SIZE + 1, size=b)
    lens[0] = 0
    return lens


def paged_inputs(gen, lens, *, h, kvh, dh, mp, dtype, quant,
                 trash_slot=None):
    """A page pool with disjoint, shuffled block tables for ``len(lens)``
    slots; ``trash_slot``'s whole table points at the trash page 0."""
    b = len(lens)
    n_pages = 1 + b * mp
    shape = (n_pages, PAGE_SIZE, kvh, dh)
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
    got = ops.paged_decode_attention(*args, softcap=softcap, **sc)
    want = ops.paged_decode_attention(*args, softcap=softcap, impl="torch",
                                      **sc)
    torch.cuda.synchronize()
    err = check_close(name, got, want, dtype)
    empty = args[4] == 0
    if not bool((got[empty] == 0).all()):
        raise AssertionError(f"{name}: an empty slot must give zeros")
    return err


def paged_phase(ops, timer):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    mp = -(-MAX_LEN // PAGE_SIZE)
    # small cases: GQA groups, f32 and bf16, float and int8 pages
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for quant in (False, True):
            for (h, kvh, dh) in ((8, 4, 64), (8, 2, 128), (16, 2, 64)):
                for softcap in (0.0, 30.0):
                    q, kp, vp, bt, kvl, sc = paged_inputs(
                        gen, edge_lens(cases, 5, 6), h=h, kvh=kvh, dh=dh,
                        mp=6, dtype=dtype, quant=quant, trash_slot=1)
                    paged_check(ops, f"paged {dtype} quant={quant} "
                                f"{(h, kvh, dh)} softcap={softcap}",
                                (q, kp, vp, bt, kvl), sc, dtype, softcap)
                    cases += 1
    log(f"paged small cases: {cases} agree with the plain version")

    entries = []
    dtype = torch.bfloat16
    for quant in (False, True):
        name = "paged_decode_int8" if quant else "paged_decode"
        # the path's head geometry at B = 8 with an empty slot and a slot
        # on the trash page: correctness only
        q, kp, vp, bt, kvl, sc = paged_inputs(
            gen, edge_lens(100 + quant, 8, mp), h=32, kvh=32, dh=128, mp=mp,
            dtype=dtype, quant=quant, trash_slot=1)
        err = paged_check(ops, f"{name} B=8 edge slots", (q, kp, vp, bt, kvl),
                          sc, dtype)
        # the serve phase's geometry, timed: B = 4 live slots of 600-1040
        # tokens with disjoint tables
        lens = np.random.default_rng(200 + quant).integers(
            600, MAX_LEN + 1, size=BATCH)
        q, kp, vp, bt, kvl, sc = paged_inputs(
            gen, lens, h=32, kvh=32, dh=128, mp=mp, dtype=dtype, quant=quant)
        args = (q, kp, vp, bt, kvl)
        err = max(err, paged_check(ops, f"{name} B={BATCH} serve geometry",
                                   args, sc, dtype))
        times = timer.times(lambda: ops.paged_decode_attention(*args, **sc))
        ms = float(np.mean(times))
        plain_ms = timer.ms(lambda: ops.paged_decode_attention(
            *args, impl="torch", **sc))
        # bytes this run's data needs: each live K/V row once (the tables
        # are disjoint), the live pages' scales and table entries, q, out
        # and kv_len
        live_tok = int(lens.sum())
        live_pages = int((-(-lens // PAGE_SIZE)).sum())
        kvh, dh = kp.shape[2], kp.shape[3]
        nbytes = (2 * live_tok * kvh * dh * kp.element_size()
                  + (2 * live_pages * kvh * 4 if quant else 0)
                  + live_pages * 4 + 2 * q.numel() * q.element_size()
                  + kvl.numel() * 4)
        flops = 4 * live_tok * q.shape[1] * dh
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        log(f"{name} B={BATCH} (32 heads x 128, kv_len {lens.tolist()}): "
            f"max err {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
            f" bound {max(t_bytes, t_ops):.4f} ms; kernel {spread(times)}")
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_attention.py:160",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    return entries


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
    for k, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{mode}: kernel {k} never launched")
    step_ms = 1e3 * st.decode_s / max(st.decode_steps - 1, 1)
    log(f"serve {mode}: {len(done)} requests, {st.prefills} prefills, "
        f"{st.decode_steps} decode steps, {st.useful_tokens} tokens in "
        f"{st.wall_s:.3f} s ({st.tokens_per_s:.1f} tok/s), decode "
        f"{step_ms:.3f} ms/step ({st.decode_tokens_per_s:.1f} tok/s), "
        f"launches {counts}, KV cache {st.cache_bytes / 2**30:.3f} GiB")
    return counts


@contextlib.contextmanager
def held_against_plain(ops, dtype, record):
    """While active, every kernel call through ``ops`` (impl None) is
    followed by its plain version on the same inputs; ``record[kernel]``
    collects (max abs error, within TOL[dtype]) of each call's outputs."""
    saved = {name: getattr(ops, name) for name in record}

    def held(name, fn):
        def call(*args, impl=None, **kw):
            got = fn(*args, impl=impl, **kw)
            if impl is None:
                kw.pop("out", None)
                want = fn(*args, impl="torch", **kw)
                if name == "flash_attention":   # (out, lse)
                    errs = [compare(g, w, dtype) for g, w in zip(got, want)]
                else:
                    errs = [compare(got, want, dtype)]
                record[name].append((max(e for e, _ in errs),
                                     all(ok for _, ok in errs)))
            return got
        return call

    for name, fn in saved.items():
        setattr(ops, name, held(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


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
    with held_against_plain(ops, pol.compute_dtype, record):
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
           "max_abs": float((a - b).abs().max()),
           "calls": {k: len(v) for k, v in record.items()},
           "calls_outside": {k: sum(not ok for _, ok in v)
                             for k, v in record.items()},
           "call_max_err": {k: max((e for e, _ in v), default=0.0)
                            for k, v in record.items()}}
    log(f"path parity {mode} {pol.compute_dtype}: prefill + 4 decode logits,"
        f" kernels vs plain: rel L2 {res['rel_l2']:.3e} (bound "
        f"{LOGIT_REL_L2_BOUND[pol.compute_dtype]}), max abs "
        f"{res['max_abs']:.3e}, max |logit| {float(b.abs().max()):.3f}; "
        f"each kernel call vs plain on its inputs (tol "
        f"{TOL[pol.compute_dtype]}): " + ", ".join(
            f"{k} {res['calls_outside'][k]}/{res['calls'][k]} outside, max "
            f"err {res['call_max_err'][k]:.3e}" for k in record))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.amp import make_policy
    from repro_torch.kernels import build, ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import scheduler as sched_mod
    from repro_torch.serve import serve_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(nvidia_smi())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = build.build_all()
    for name, r in report.items():
        (build.BUILD_DIR / f"{name}.log").write_text(r["log"])
    log(f"built {sorted(report) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")

    timer = Timer()
    entries = [flash_phase(ops, timer)] + paged_phase(ops, timer)
    del timer
    torch.cuda.empty_cache()

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
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")

    by_name = {
        "flash_fwd": launches["paged"]["flash_fwd"]
        + launches["paged_int8"]["flash_fwd"],
        "paged_decode": launches["paged"]["paged_decode"],
        "paged_decode_int8": launches["paged_int8"]["paged_decode"],
    }
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
