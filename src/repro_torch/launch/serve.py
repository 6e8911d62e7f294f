"""Serve a decoder LM with batched requests on the card (counterpart of
``examples/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve \
      [--arch deepseek-7b|rwkv6-1.6b] [--batch 4] [--prompt-len 32] \
      [--new-tokens 16] [--mode raw|continuous] \
      [--cache-mode contiguous|paged|paged_int8] [--full-width] \
      [--device cuda|cpu]

``--mode raw`` prefills a batch of random prompts and decodes it in
lockstep, reporting tokens/s; for rwkv6-1.6b that prefill is unmasked and
runs the chunked ``wkv6`` kernel (a prompt longer than 64 tokens must be a
multiple of 64).  ``--mode continuous`` runs ``ContinuousScheduler`` over
a synthetic mixed-length workload and reports slot utilisation,
throughput and the KV and recurrent-state footprints; rwkv6-1.6b is not
pageable and serves with ``--cache-mode contiguous``, its slot prefills
through the masked sequential scan.  As in the example, there is no
cohort mode here.  Without ``--full-width``
the model is the reduced ``smoke_variant`` (as in the example); with it the
model has its published widths and depth and runs in bf16 (the smoke
variant runs in f32, as the example does).  Weights are random, drawn from
a fixed seed.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import transformer as T

logger = logging.getLogger("repro_torch.serve")
SEED = 0   # weights, prompts and the workload are drawn from it


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_scheduler(args, cfg, pol, params):
    from repro_torch.serve.scheduler import ContinuousScheduler, Request
    max_len = args.prompt_len + args.new_tokens
    sched = ContinuousScheduler(
        params, cfg, pol, batch=args.batch, max_len=max_len,
        prefill_len=args.prompt_len, cache_mode=args.cache_mode,
        page_size=args.page_size, num_pages=args.num_pages,
        cache_dtype=pol.compute_dtype, device=args.device)
    rng = np.random.default_rng(SEED)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(4, args.prompt_len + 1)),
                              dtype=np.int32)
        sched.submit(Request(
            rid=i, prompt=prompt,
            max_new_tokens=int(rng.integers(2, args.new_tokens + 1))))
    done = sched.run()
    st = sched.stats
    logger.info("continuous: %d requests done, %d useful tokens, %d wasted "
                "slots", len(done), st.useful_tokens, st.wasted_slots)
    logger.info("slot utilisation %.3f, %.1f tok/s, decode %.1f tok/s, p50 "
                "latency %.3fs", st.slot_utilisation, st.tokens_per_s,
                st.decode_tokens_per_s,
                float(np.median([r.latency_s for r in done])))
    logger.info("KV cache bytes %d (%s), recurrent state bytes %d",
                st.cache_bytes, args.cache_mode, st.state_bytes)
    if sched.allocator is not None:
        logger.info("paged cache: %d-page pool, %d preemptions, %d pages "
                    "leaked", sched.num_pages - 1, st.preemptions,
                    sched.allocator.in_use)
        if sched.allocator.in_use:
            raise RuntimeError("pages leaked after drain")
    if st.nonfinite_logits:
        raise RuntimeError(f"{st.nonfinite_logits} non-finite logit rows")
    return sched


def run_raw(args, cfg, pol, params):
    b, s = args.batch, args.prompt_len
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           dtype=torch.int32).to(args.device)
    state = T.init_decode_state(cfg, b, s + args.new_tokens,
                                pol.compute_dtype, device=args.device)
    t0 = time.perf_counter()
    logits, state = T.prefill(params, prompt, cfg, pol, state=state)
    _sync(args.device)
    t_prefill = time.perf_counter() - t0
    logger.info("prefill: %d x %d tokens in %.3fs (%.0f tok/s)", b, s,
                t_prefill, b * s / t_prefill)
    # rows of logits holding a NaN or inf, counted on the device
    nonfinite = (~torch.isfinite(logits).all(-1)).sum()
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(args.new_tokens - 1):
        logits, state = T.decode_step(params, tok, state, cfg, pol)
        nonfinite += (~torch.isfinite(logits).all(-1)).sum()
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    _sync(args.device)
    t_decode = time.perf_counter() - t0
    n = b * (args.new_tokens - 1)
    if n:
        logger.info("decode: %d tokens in %.3fs (%.0f tok/s, %.1f ms/step)",
                    n, t_decode, n / t_decode,
                    1e3 * t_decode / (args.new_tokens - 1))
    gen_ids = torch.cat(out, dim=1).cpu().numpy()
    logger.info("generated ids (first request): %s", gen_ids[0].tolist())
    if int(nonfinite):
        raise RuntimeError(f"{int(nonfinite)} non-finite logit rows")
    return gen_ids


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-7b",
                    choices=["deepseek-7b", "rwkv6-1.6b"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--mode", default="raw", choices=["raw", "continuous"])
    ap.add_argument("--requests", type=int, default=12,
                    help="workload size for --mode continuous")
    ap.add_argument("--cache-mode", default="contiguous",
                    choices=["contiguous", "paged", "paged_int8"])
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page pool size incl. the trash page (default: "
                         "full provisioning); small pools force preemption")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true",
                    help="the published configuration instead of the "
                         "reduced smoke variant")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = smoke_variant(cfg)
    pol = make_policy("bf16" if args.full_width else "f32")
    params = T.init_model(cfg, seed=SEED, dtype=pol.param_dtype,
                          device=args.device)
    logger.info("serving %s (%s) on %s: %.2fM params", cfg.arch_id,
                "full width" if args.full_width else "reduced", args.device,
                cfg.param_count() / 1e6)
    if args.mode == "continuous":
        return run_scheduler(args, cfg, pol, params)
    return run_raw(args, cfg, pol, params)


if __name__ == "__main__":
    main()
