"""Where the serving time goes on the card: a torch.profiler breakdown of
one prefill and of steady-state decode steps.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      [--arch deepseek-7b|rwkv6-1.6b|granite-moe-3b-a800m|\
              qwen3-moe-30b-a3b|jamba-1.5-large-398b|whisper-small|\
              qwen2-vl-7b] \
      [--cache-mode paged|paged_int8] \
      [--moe-impl dense|a2a|replicated] [--steps 8] [--batch 4] \
      [--full-width [--layers N]]

Builds the model (full width and depth with ``--full-width``, at
``--layers`` layers if given, else the smoke variant; fewer layers than
one block keep a prefix of the block pattern: jamba at ``--layers 4`` is
(attn, dense), (mamba, moe), (mamba, dense), (mamba, moe)) in bf16 with
seeded random weights and runs the geometry of ``chip_smoke.py``'s serve
phases at ``--batch`` slots (default 4).  deepseek-7b, the MoE decoders,
jamba (its mamba rows beside the paged attention layer) and whisper-small
(each slot's cross caches beside it, filled from the slot's own frames
at its admission): fills the slots with 1024-token prompts through
``prefill_into_slot``, in ``--cache-mode``, the MoE layers under
``--moe-impl`` (default ``dense``, the serving default).  qwen2-vl-7b
fills its slots text-only, as the schedulers do, after one more phase,
``prefill_vision``: the raw mode's prefill of batch x 1024 tokens with
256 vision embeddings over each prompt's first positions, into a
contiguous state.  rwkv6-1.6b: the raw mode's unmasked
prefill of batch x 1024 tokens (24 ``wkv6`` launches), all on one state.
Then ``--steps`` decode steps of the slots.  For each phase it prints one JSON line: wall
time (host clock around an unprofiled loop that ends in a synchronize),
device busy time (the union of the CUDA kernels' spans in the trace of a
second, profiled loop; their summed durations beside it), the idle share (1 - busy / wall), the device time
by kind of kernel (the port's own, GEMMs, elementwise and copies,
reductions, other), each of the port's kernels' time and share of busy,
and the kernels that took the most device time.  Then one more line
splits a decode step's device time by the port's functions
(``decode_step_split``): attention (``layers.apply_attention``, the paged
decode kernel inside), and in an MoE layer the router (``moe._router``),
the expert products (``moe._dense_experts``, ``moe._expert_ffn``) and
the dispatch and combine (``moe._dense_combine``, ``moe._group_local``,
``moe._combine_local``), and in a mamba layer its in-projection
(``mamba._in_proj``), causal conv (``mamba._causal_conv``), selective
scan (``mamba._selective_scan``: x_proj, dt, the recurrence and the
contraction with C) and gated out-projection (``mamba._out_proj``), and
a dense layer's MLP (``layers.apply_mlp``), and an encoder-decoder's
encoder (``transformer._encode``: its layers and final norm) and cross
sublayers (``transformer._apply_cross``: the norm and the cross-attention),
each the device time of the kernels launched
inside it, from a third loop profiled with those functions wrapped in
``record_function`` spans; the rest of the busy time (norms, embedding,
the LM head) beside them.  Spans do not nest: a call inside an open span
(the encoder's attention and MLP, the cross sublayer's attention) counts
in the outer one.  An encoder-decoder's prefill gets the same split
(``prefill_split``): the encoder's cost at each admission.  The spans'
own trace events stay out of the busy time of the lines before.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import cut_depth, get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.launch.serve import vision_embeds
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
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


# a decode step's device time split by the port's functions: span name ->
# the (module, function) pairs it wraps; no span runs inside another
SPANS = {"attention": ((L, "apply_attention"),),
         "moe_router": ((MOE, "_router"),),
         "moe_experts": ((MOE, "_dense_experts"), (MOE, "_expert_ffn")),
         "moe_dispatch_combine": ((MOE, "_dense_combine"),
                                  (MOE, "_group_local"),
                                  (MOE, "_combine_local")),
         "mamba_in_proj": ((MB, "_in_proj"),),
         "mamba_conv": ((MB, "_causal_conv"),),
         "mamba_scan": ((MB, "_selective_scan"),),
         "mamba_out_proj": ((MB, "_out_proj"),),
         "mlp": ((L, "apply_mlp"),),
         "encoder": ((T, "_encode"),),
         "cross_attention": ((T, "_apply_cross"),)}
SPAN_PREFIX = "profile_serve::"


@contextlib.contextmanager
def _spanned():
    """While active, each function of ``SPANS`` runs inside a
    ``record_function`` span of its name; the modules' callers look them
    up at call time, so every call is wrapped.  A call made inside an open
    span opens none of its own: its kernels count in the outer span."""
    saved = []
    open_spans = []

    def wrap(span, fn):
        @functools.wraps(fn)
        def call(*a, **k):
            if open_spans:
                return fn(*a, **k)
            open_spans.append(span)
            try:
                with record_function(SPAN_PREFIX + span):
                    return fn(*a, **k)
            finally:
                open_spans.pop()
        return call

    for span, targets in SPANS.items():
        for mod, name in targets:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, wrap(span, getattr(mod, name)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _split(name, fn, iters, busy_ms, extra=None):
    """Device ms per iteration of the kernels launched inside each span
    (the CPU-side span's device total), from a loop profiled under
    ``_spanned``; ``rest_ms`` is ``busy_ms`` (from ``_phase``'s trace)
    less the spans.  ``extra`` (a dict) joins the printed line."""
    with _spanned(), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = {span: 0.0 for span in SPANS}
    for e in prof.key_averages():
        if e.key.startswith(SPAN_PREFIX) and \
                e.device_type == torch.autograd.DeviceType.CPU:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            spans[e.key[len(SPAN_PREFIX):]] += us / 1e3 / iters
    out = {"phase": name, "span_device_ms": spans,
           "rest_ms": busy_ms - sum(spans.values()),
           "device_busy_ms": busy_ms, **(extra or {})}
    print(json.dumps(out), flush=True)
    return out


def _serve_paged(cfg, pol, params, args):
    max_len = PROMPT_LEN + 2 * args.steps + 16  # timed + profiled steps
    mp = -(-max_len // PAGE_SIZE)
    paged = T.PagedCacheConfig(page_size=PAGE_SIZE,
                               num_pages=1 + args.batch * mp,
                               quantized=args.cache_mode == "paged_int8")
    state = T.init_decode_state(cfg, args.batch, max_len, pol.compute_dtype,
                                paged=paged, device="cuda",
                                enc_len=cfg.enc_seq
                                if cfg.is_encoder_decoder else 0)
    T.set_block_tables(state, 1 + np.arange(args.batch * mp, dtype=np.int32)
                       .reshape(args.batch, mp))
    toks = _prompts(cfg, args.batch)
    frames = _frames(cfg, args.batch)

    def prefill(slot):
        prefill_into_slot(params, toks[slot:slot + 1], PROMPT_LEN, state,
                          slot, cfg, pol, moe_impl=args.moe_impl,
                          enc_frames=None if frames is None
                          else frames[slot:slot + 1])
    for slot in range(1, args.batch) if args.batch > 1 else (0,):
        prefill(slot)
    # slot 0's prefill is the measured one (the others, or at batch 1 a
    # first prefill of slot 0, warmed up the path); prefilling it again
    # rewrites the same pages (and cross caches)
    res = _phase("prefill", lambda: prefill(0), 3)
    if cfg.is_encoder_decoder:
        _split("prefill_split", lambda: prefill(0), 3,
               res["device_busy_ms"])
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


def _serve_vision(cfg, pol, params, args):
    """A vision model's raw prefill with its stub embeddings (batch,
    n_vision_tokens, d_model), drawn as the serve CLI draws them, into a
    contiguous state of the batch; the state is dropped after the
    phase."""
    state = T.init_decode_state(cfg, args.batch, PROMPT_LEN,
                                pol.compute_dtype, device="cuda")
    toks = _prompts(cfg, args.batch)
    vision = torch.from_numpy(vision_embeds(
        cfg, np.random.default_rng(SEED + 3), args.batch)).cuda()
    prefill = lambda: T.prefill(params, toks, cfg, pol, state=state,
                                vision_embeds=vision)
    prefill()
    _phase("prefill_vision", prefill, 3)


def _frames(cfg, batch):
    """An encoder-decoder's frames, one (enc_seq, d_model) row a slot, on
    the card; None for any other model."""
    if not cfg.is_encoder_decoder:
        return None
    rng = np.random.default_rng(SEED + 1)
    return torch.from_numpy((0.1 * rng.standard_normal(
        (batch, cfg.enc_seq, cfg.d_model))).astype(np.float32)).cuda()


def _prompts(cfg, batch):
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch, PROMPT_LEN), dtype=np.int32)).cuda()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-7b",
                    choices=["deepseek-7b", "rwkv6-1.6b",
                             "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
                             "jamba-1.5-large-398b", "whisper-small",
                             "qwen2-vl-7b"])
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth of the full-width model (default: the "
                         "config's; chip_smoke.py serves qwen3-moe-30b-a3b "
                         "at 8 of its 48 and jamba-1.5-large-398b at 4 of "
                         "its 72)")
    ap.add_argument("--cache-mode", default="paged",
                    choices=["paged", "paged_int8"],
                    help="the KV layout (rwkv6-1.6b has no KV)")
    ap.add_argument("--moe-impl", default="dense",
                    choices=["dense", "a2a", "replicated"],
                    help="an MoE model's expert path")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card: no CUDA device")
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = smoke_variant(cfg)
    elif args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    pol = make_policy("bf16")
    params = T.init_model(cfg, seed=SEED, dtype=pol.param_dtype,
                          device="cuda")
    rwkv = args.arch == "rwkv6-1.6b"
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "arch": cfg.arch_id, "full_width": args.full_width,
                      "layers": cfg.n_layers,
                      "cache_mode": None if rwkv else args.cache_mode,
                      "moe_impl": args.moe_impl if cfg.has_moe else None,
                      "batch": args.batch, "prompt_len": PROMPT_LEN}),
          flush=True)
    if cfg.n_vision_tokens:
        _serve_vision(cfg, pol, params, args)
        torch.cuda.empty_cache()
    state = (_serve_rwkv if rwkv else _serve_paged)(cfg, pol, params, args)
    cur = torch.zeros((args.batch, 1), dtype=torch.int64, device="cuda")

    def step():
        logits, _ = T.decode_step(params, cur, state, cfg, pol,
                                  moe_impl=args.moe_impl)
        cur.copy_(logits.argmax(-1, keepdim=True))

    step()
    res = _phase("decode_step", step, args.steps)
    _split("decode_step_split", step, args.steps, res["device_busy_ms"])


if __name__ == "__main__":
    main()
