"""Serve a decoder LM with batched requests on the card (counterpart of
``examples/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve \
      [--arch deepseek-7b|rwkv6-1.6b|gemma2-27b|qwen1.5-32b|\
              deepseek-coder-33b|granite-moe-3b-a800m|qwen3-moe-30b-a3b|\
              jamba-1.5-large-398b|whisper-small|qwen2-vl-7b] \
      [--moe-impl dense|a2a|replicated] [--batch 4] [--prompt-len 32] \
      [--new-tokens 16] [--mode raw|cohort|continuous] \
      [--cache-mode contiguous|paged|paged_int8] \
      [--prefix-cache [--prefix-groups 2]] [--full-width] \
      [--device cuda|cpu]

``--mode raw`` prefills a batch of random prompts and decodes it in
lockstep, reporting tokens/s; for rwkv6-1.6b that prefill is unmasked and
runs the chunked ``wkv6`` kernel (a prompt longer than 64 tokens must be a
multiple of 64).  ``--mode cohort`` and ``--mode continuous`` run
``CohortScheduler`` and ``ContinuousScheduler`` over a synthetic
mixed-length workload and report slot utilisation and throughput; the
continuous mode also the KV and recurrent-state footprints.  rwkv6-1.6b is
not pageable and serves continuously with ``--cache-mode contiguous``, its
slot prefills through the masked sequential scan; cohort mode refuses it
(left padding would step its recurrent state).  gemma2-27b keeps
sliding-window rings in its local layers: it is not pageable either, and
its continuous prefill bucket (``--prompt-len``) may not exceed its window
(16 in the smoke variant, 4096 at full width); a raw or cohort prefill
wider than the window keeps the ring's last positions.  qwen1.5-32b (QKV
biases) and deepseek-coder-33b (56 query heads over 8 KV heads) serve in
every mode, and so do the MoE decoders granite-moe-3b-a800m (40 experts,
top-8; 24 query heads over 8 KV heads at Dh 64) and qwen3-moe-30b-a3b
(128 experts, top-8; query/key norms; 32 over 4 at Dh 128), whose MoE
layers run ``--moe-impl``: ``dense`` (the default, as the reference's
schedulers: every expert on every token) or ``a2a`` / ``replicated``
(on one device both are the capacity path, which drops a token's
assignment past its expert's capacity).  The hybrid
jamba-1.5-large-398b (one attention layer and seven mamba layers a block,
MoE on every other layer) serves in raw and continuous modes, its
attention layers in any ``--cache-mode`` and its mamba layers' conv and
ssm rows per slot beside them (the continuous mode logs both
footprints); its raw prefill is unmasked and runs the chunked scan (a
prompt longer than 128 tokens must be a multiple of 128), its slot
prefills the masked sequential one; cohort mode and ``--prefix-cache``
refuse it, as they refuse rwkv6-1.6b.  At ``--full-width`` its 398 B
parameters do not fit one card (``chip_smoke.py`` and
``profile_serve.py --layers 4`` serve its first 4 layers).  The
encoder-decoder whisper-small serves in raw and continuous modes, in any
``--cache-mode``: every request brings its own frame embeddings (enc_seq,
d_model), 0.1 times a standard normal drawn from the workload's seed; its
prefill (a slot's admission) runs the encoder over them and fills the
slot's cross caches, which its decode steps read; cohort mode and
``--prefix-cache`` refuse it.  The vision-language qwen2-vl-7b (M-RoPE,
28 query heads over 4 KV heads, QKV biases) serves in every mode and
``--cache-mode``: the raw mode's prefill takes vision embeddings, 0.1
times a standard normal (batch, 256, d_model) (8 in the smoke variant)
from the workload's seed, over the first positions of each prompt
(``--prompt-len`` at least that many); the cohort and continuous modes
serve text only, as the reference's schedulers do; ``--prefix-cache``
refuses it.  ``--prefix-cache``
(continuous, paged cache modes) shares cached prompt-prefix pages across
slots: the workload's prompts then start with one of ``--prefix-groups``
shared heads, and ``max_len`` gains ``--prompt-len`` of headroom so a
suffix prefill fits in the slot's extent.  Without ``--full-width`` the
model is the reduced ``smoke_variant`` (as in the example); with it the
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
    from repro_torch.serve.scheduler import (CohortScheduler,
                                             ContinuousScheduler, Request)
    max_len = args.prompt_len + args.new_tokens
    if args.prefix_cache:
        # headroom for a suffix bucket (prefill_len wide) at offset covered
        max_len += args.prompt_len
    if args.mode == "continuous":
        sched = ContinuousScheduler(
            params, cfg, pol, batch=args.batch, max_len=max_len,
            prefill_len=args.prompt_len, cache_mode=args.cache_mode,
            page_size=args.page_size, num_pages=args.num_pages,
            cache_dtype=pol.compute_dtype, prefix_cache=args.prefix_cache,
            moe_impl=args.moe_impl, device=args.device)
    else:
        caps = cfg.decode_caps
        if caps.needs_exact_prefill or caps.cross_cache:
            raise SystemExit(
                "cohort mode left-pads prompts (corrupts recurrent scans) "
                "and has no per-request encoder-frame plumbing -- serve "
                f"{cfg.arch_id} with --mode continuous")
        sched = CohortScheduler(params, cfg, pol, batch=args.batch,
                                max_len=max_len, moe_impl=args.moe_impl,
                                device=args.device)
    rng = np.random.default_rng(SEED)
    # shared heads, so that --prefix-cache has hits
    groups = [rng.integers(0, cfg.vocab_size,
                           size=max(args.prompt_len // 2, 1), dtype=np.int32)
              for _ in range(args.prefix_groups)]
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(4, args.prompt_len + 1)),
                              dtype=np.int32)
        if args.prefix_cache:
            head = groups[i % len(groups)]
            prompt = np.concatenate([head, prompt])[: args.prompt_len]
        sched.submit(Request(
            rid=i, prompt=prompt,
            max_new_tokens=int(rng.integers(2, args.new_tokens + 1)),
            enc_frames=enc_frames(cfg, rng)))
    done = sched.run()
    st = sched.stats
    logger.info("%s: %d requests done, %d useful tokens, %d wasted slots",
                args.mode, len(done), st.useful_tokens, st.wasted_slots)
    logger.info("slot utilisation %.3f, %.1f tok/s, decode %.1f tok/s, p50 "
                "latency %.3fs", st.slot_utilisation, st.tokens_per_s,
                st.decode_tokens_per_s,
                float(np.median([r.latency_s for r in done])))
    if args.mode == "cohort":
        logger.info("cohorts %d", st.cohorts)
    else:
        logger.info("KV cache bytes %d (%s), per-slot state bytes %d "
                    "(recurrent rows, cross caches)", st.cache_bytes,
                    args.cache_mode, st.state_bytes)
    alloc = getattr(sched, "allocator", None)
    if alloc is not None:
        logger.info("paged cache: %d-page pool, %d preemptions, %d pages "
                    "leaked", sched.num_pages - 1, st.preemptions,
                    alloc.in_use)
        if args.prefix_cache:
            logger.info(
                "prefix cache: hit rate %.2f (%d/%d, %d full), %d pages "
                "shared, %d prefill tokens saved (%d computed), %d COW "
                "copies, %d cached pages held, %d reclaimed",
                st.prefix_hit_rate, st.prefix_hits, st.prefix_lookups,
                st.prefix_full_hits, st.pages_shared,
                st.prefill_tokens_saved, st.prefill_tokens, st.cow_copies,
                alloc.cached, alloc.reclaimed)
        if alloc.in_use or alloc.available != sched.num_pages - 1:
            raise RuntimeError("pages leaked after drain")
    if st.nonfinite_logits:
        raise RuntimeError(f"{st.nonfinite_logits} non-finite logit rows")
    return sched


def enc_frames(cfg, rng, batch=None):
    """An encoder-decoder request's frame embeddings, 0.1 times a standard
    normal (enc_seq, d_model) float32 from ``rng`` ((batch, enc_seq,
    d_model) with ``batch``); None for any other model."""
    if not cfg.is_encoder_decoder:
        return None
    shape = (cfg.enc_seq, cfg.d_model) if batch is None else \
        (batch, cfg.enc_seq, cfg.d_model)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


def vision_embeds(cfg, rng, batch):
    """A vision model's stub patch embeddings, 0.1 times a standard
    normal (batch, n_vision_tokens, d_model) float32 from ``rng``; None
    for any other model."""
    if not cfg.n_vision_tokens:
        return None
    return (0.1 * rng.standard_normal(
        (batch, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)


def run_raw(args, cfg, pol, params):
    b, s = args.batch, args.prompt_len
    if s < cfg.n_vision_tokens:
        raise SystemExit(f"{cfg.arch_id}: --prompt-len {s} cannot hold its "
                         f"{cfg.n_vision_tokens} vision embeddings")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           dtype=torch.int32).to(args.device)
    frames = enc_frames(cfg, np.random.default_rng(SEED + 1), b)
    vision = vision_embeds(cfg, np.random.default_rng(SEED + 3), b)
    enc_len = cfg.enc_seq if cfg.is_encoder_decoder else 0
    state = T.init_decode_state(cfg, b, s + args.new_tokens,
                                pol.compute_dtype, device=args.device,
                                enc_len=enc_len)
    t0 = time.perf_counter()
    logits, state = T.prefill(
        params, prompt, cfg, pol, state=state, moe_impl=args.moe_impl,
        enc_frames=None if frames is None
        else torch.from_numpy(frames).to(args.device),
        vision_embeds=None if vision is None
        else torch.from_numpy(vision).to(args.device))
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
        logits, state = T.decode_step(params, tok, state, cfg, pol,
                                      moe_impl=args.moe_impl)
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
                    choices=["deepseek-7b", "rwkv6-1.6b", "gemma2-27b",
                             "qwen1.5-32b", "deepseek-coder-33b",
                             "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
                             "jamba-1.5-large-398b", "whisper-small",
                             "qwen2-vl-7b"],
                    help="the architectures the port serves")
    ap.add_argument("--moe-impl", default="dense",
                    choices=["dense", "a2a", "replicated"],
                    help="an MoE model's expert path: every expert on "
                         "every token, or the capacity path (a2a and "
                         "replicated are the same on one device)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--mode", default="raw",
                    choices=["raw", "cohort", "continuous"])
    ap.add_argument("--requests", type=int, default=12,
                    help="workload size for the scheduler modes")
    ap.add_argument("--cache-mode", default="contiguous",
                    choices=["contiguous", "paged", "paged_int8"])
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page pool size incl. the trash page (default: "
                         "full provisioning); small pools force preemption")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share cached prompt-prefix pages across slots "
                         "(continuous mode, paged cache modes); the "
                         "workload gains shared heads so that hits occur")
    ap.add_argument("--prefix-groups", type=int, default=2,
                    help="distinct shared heads in the workload")
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
    if args.mode != "raw":
        return run_scheduler(args, cfg, pol, params)
    return run_raw(args, cfg, pol, params)


if __name__ == "__main__":
    main()
