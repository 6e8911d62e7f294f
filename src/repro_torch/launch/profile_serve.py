"""Where the serving time goes on the card: a torch.profiler breakdown of
one prefill and of steady-state decode steps.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      [--arch deepseek-7b|rwkv6-1.6b] [--cache-mode paged|paged_int8] \
      [--steps 8] [--batch 4] [--full-width]

Builds the model (full width and depth with ``--full-width``, else the
smoke variant) in bf16 with seeded random weights and runs the geometry of
``chip_smoke.py``'s serve phases at ``--batch`` slots (default 4).
deepseek-7b: fills the slots with 1024-token prompts through
``prefill_into_slot``, in ``--cache-mode``.  rwkv6-1.6b: the raw mode's
unmasked prefill of batch x 1024 tokens (24 ``wkv6`` launches), all on one
state.  Then ``--steps`` decode steps of the slots.  For each phase it prints one JSON line: wall
time (host clock around an unprofiled loop that ends in a synchronize),
device busy time (the union of the CUDA kernels' spans in the trace of a
second, profiled loop; their summed durations beside it), the idle share (1 - busy / wall), the device time
by kind of kernel (the port's own, GEMMs, elementwise and copies,
reductions, other), each of the port's kernels' time and share of busy,
and the kernels that took the most device time.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import transformer as T
from repro_torch.serve.serve_step import prefill_into_slot

BATCH, PROMPT_LEN, PAGE_SIZE, SEED = 4, 1024, 16, 0


def _busy_ms(prof):
    """Device ms during which at least one CUDA event of the trace ran:
    the union of their spans, so a kernel that overlaps another (a
    programmatic dependent launch waits under the kernel it depends on)
    counts once."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def _kernel_times(prof):
    """(total device ms, [(kernel name, ms, count)] by device time) over
    the CUDA kernel events of a trace; the total sums the events' spans
    (``_busy_ms`` counts overlapping ones once)."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


# the port's kernels by the name of their CUDA function
PORT_KERNELS = ("flash_fwd", "bwd_prep", "bwd_hopper", "bwd_fused",
                "bwd_post", "dq_f32", "dkv_f32", "paged_decode",
                "layernorm_kernel", "layernorm_bwd_kernel",
                "bias_gelu_kernel", "bias_gelu_bwd_kernel", "colsum_kernel",
                "lamb_kernel", "wkv6_kernel")
# device time by kind of kernel, matched on the kernel's name in order
KINDS = (("port kernels", PORT_KERNELS),
         ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
         ("elementwise and copy", ("elementwise", "copy")),
         ("reduction", ("reduce",)))


def _by_kind(rows, iters):
    out = {kind: 0.0 for kind, _ in KINDS}
    out["other"] = 0.0
    for name, ms, _ in rows:
        kind = next((k for k, keys in KINDS
                     if any(key in name for key in keys)), "other")
        out[kind] += ms / iters
    return out


def _phase(name, fn, iters, extra=None):
    """Wall time from an unprofiled loop (the profiler's host tracing slows
    every op), device busy time from a second, profiled loop.  ``extra(prof,
    iters)`` may add fields read from the trace."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    summed, rows = _kernel_times(prof)
    busy = _busy_ms(prof) / iters
    port = {}
    for kname, ms, _ in rows:
        key = next((k for k in PORT_KERNELS if k in kname), None)
        if key is not None:
            port[key] = port.get(key, 0.0) + ms / iters
    out = {"phase": name, "wall_ms": wall, "device_busy_ms": busy,
           "kernel_ms_summed": summed / iters,
           "idle_share": 1.0 - busy / wall if wall else None,
           "device_ms_by_kind": _by_kind(rows, iters),
           "port_kernel_ms": port,
           "port_kernel_share_of_busy": {k: ms / busy for k, ms in
                                         port.items()} if busy else {},
           "top_kernels": [{"name": k[:90], "ms_per_iter": ms / iters,
                            "launches_per_iter": n / iters}
                           for k, ms, n in rows[:10]]}
    if extra is not None:
        out.update(extra(prof, iters))
    print(json.dumps(out), flush=True)
    return out


def _serve_deepseek(cfg, pol, params, args):
    max_len = PROMPT_LEN + 2 * args.steps + 16  # timed + profiled steps
    mp = -(-max_len // PAGE_SIZE)
    paged = T.PagedCacheConfig(page_size=PAGE_SIZE,
                               num_pages=1 + args.batch * mp,
                               quantized=args.cache_mode == "paged_int8")
    state = T.init_decode_state(cfg, args.batch, max_len, pol.compute_dtype,
                                paged=paged, device="cuda")
    T.set_block_tables(state, 1 + np.arange(args.batch * mp, dtype=np.int32)
                       .reshape(args.batch, mp))
    toks = _prompts(cfg, args.batch)
    for slot in range(1, args.batch) if args.batch > 1 else (0,):
        prefill_into_slot(params, toks[slot:slot + 1], PROMPT_LEN,
                          state, slot, cfg, pol)
    # slot 0's prefill is the measured one (the others, or at batch 1 a
    # first prefill of slot 0, warmed up the path); prefilling it again
    # rewrites the same pages
    _phase("prefill", lambda: prefill_into_slot(
        params, toks[:1], PROMPT_LEN, state, 0, cfg, pol), 3)
    state["pos"].fill_(PROMPT_LEN)
    return state


def _serve_rwkv(cfg, pol, params, args):
    state = T.init_decode_state(cfg, args.batch, PROMPT_LEN, device="cuda")
    toks = _prompts(cfg, args.batch)

    # one state threads through every prefill: their cost does not depend
    # on its values, and prefill sets pos to the prompt length each time
    prefill = lambda: T.prefill(params, toks, cfg, pol, state=state)
    prefill()
    _phase("prefill", prefill, 3)
    return state


def _prompts(cfg, batch):
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch, PROMPT_LEN), dtype=np.int32)).cuda()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-7b",
                    choices=["deepseek-7b", "rwkv6-1.6b"])
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--cache-mode", default="paged",
                    choices=["paged", "paged_int8"],
                    help="deepseek-7b's KV layout (rwkv6-1.6b has no KV)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card: no CUDA device")
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = smoke_variant(cfg)
    pol = make_policy("bf16")
    params = T.init_model(cfg, seed=SEED, dtype=pol.param_dtype,
                          device="cuda")
    rwkv = args.arch == "rwkv6-1.6b"
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "arch": cfg.arch_id, "full_width": args.full_width,
                      "cache_mode": None if rwkv else args.cache_mode,
                      "batch": args.batch, "prompt_len": PROMPT_LEN}),
          flush=True)
    state = (_serve_rwkv if rwkv else _serve_deepseek)(cfg, pol, params,
                                                        args)
    cur = torch.zeros((args.batch, 1), dtype=torch.int64, device="cuda")

    def step():
        logits, _ = T.decode_step(params, cur, state, cfg, pol)
        cur.copy_(logits.argmax(-1, keepdim=True))

    step()
    _phase("decode_step", step, args.steps)


if __name__ == "__main__":
    main()
