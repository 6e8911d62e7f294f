"""whisper-small served by the port against the JAX package, at
``smoke_variant`` sizes (``tests/torch_whisper.py``), in f32: twins of
the reference's whisper rows of ``tests/test_slot_state.py`` --

* the capability row (``:49``) and the footprints (``:295-301``: both
  ``state_bytes``, the cross caches, and ``cache_bytes``, the
  self-attention KV, non-zero and equal to the reference adapter's);
* a request without ``enc_frames`` raises ``ValueError`` (``:71-73``);
* ``ContinuousScheduler``'s outputs equal the reference's
  ``greedy_generate`` of each request, token for token (``:212``), in the
  contiguous and the paged cache;
* a refill of slot 0 with a new prompt and new frames leaves slot 1's
  logits in the same bits (``:218``);

and beside them: ``decode_step`` embeds each slot at its own position
(against the reference's ``decode_step`` on the same state), the
adapter's ``reset_slot`` zeroes a slot's cross rows, and the prefix
cache, the cohort scheduler and the serve CLI's cohort mode refuse
whisper while its raw and continuous modes serve it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serve import serve_step as JSS
from repro.serve.slot_state import SlotStateAdapter as JAdapter
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serve import scheduler as S
from repro_torch.serve import serve_step as SS
from repro_torch.serve.slot_state import SlotStateAdapter
from torch_whisper import (ARCH, JPOL, LOGIT_TOL, POL, frames, model,
                           tokens)
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

MAX_LEN, BUCKET = 64, 8


def _bucketed(prompt, bucket=BUCKET):
    t = np.zeros((1, bucket), np.int32)
    t[0, :len(prompt)] = prompt
    return torch.from_numpy(t), len(prompt)


def test_capability_row_and_footprints():
    """whisper's row of the capability matrix (pageable, not
    prefix-shareable, a cross cache), the reference's; the adapter's
    per-slot state (the cross caches: ``enc_len`` = ``enc_seq`` rows a
    slot and layer) and KV footprints both non-zero and equal to the
    reference adapter's, contiguous and paged -- but for the block
    tables: the port's layers share one, the reference stacks one a
    layer."""
    jcfg, cfg, jp, tp = model()
    c = cfg.decode_caps
    assert (c.pageable, c.prefix_shareable, c.needs_exact_prefill,
            c.constant_state, c.windowed, c.cross_cache) == (
        True, False, False, False, False, True)
    for paged in (None, T.PagedCacheConfig(page_size=4, num_pages=33)):
        ad = SlotStateAdapter(tp, cfg, POL, batch=2, max_len=MAX_LEN,
                              paged_cfg=paged, device="cpu")
        jpaged = None if paged is None else JT.PagedCacheConfig(
            page_size=4, num_pages=33)
        jad = JAdapter(jp, jcfg, JPOL, batch=2, max_len=MAX_LEN,
                       paged_cfg=jpaged)
        assert ad.has_slot_state and ad.enc_len == cfg.enc_seq
        assert ad.state_bytes() > 0 and ad.cache_bytes() > 0
        tables = 0 if paged is None else \
            (cfg.n_layers - 1) * 2 * ad.max_pages * 4
        assert (ad.state_bytes(), ad.cache_bytes() + tables) == (
            jad.state_bytes(), jad.cache_bytes())


def test_missing_frames_raise():
    """An encoder-decoder request without ``enc_frames`` is refused at
    ``submit``, naming them, as the reference refuses it; the adapter and
    ``prefill_into_slot`` refuse a prefill without frames or with a
    suffix start."""
    _, cfg, _, tp = model()
    sched = S.ContinuousScheduler(tp, cfg, POL, batch=2, max_len=32,
                                  device="cpu")
    with pytest.raises(ValueError, match="enc_frames"):
        sched.submit(S.Request(rid=0, prompt=np.arange(4, dtype=np.int32)))
    state = sched.adapter.init_state()
    toks, n = _bucketed(np.arange(1, 5))
    f = torch.from_numpy(frames(cfg, 1, 30))
    with pytest.raises(ValueError, match="enc_frames"):
        sched.adapter.prefill(state, toks, n, 0)
    with pytest.raises(ValueError, match="prefix resume"):
        sched.adapter.prefill(state, toks, n, 0, start=4, enc_frames=f)
    with pytest.raises(ValueError, match="enc_frames"):
        SS.prefill_into_slot(tp, toks, n, state, 0, cfg, POL)


@functools.lru_cache(maxsize=None)
def _trace():
    """4 requests of 3-8 prompt tokens, each with its own frames, and the
    reference's greedy generation of each (6 new tokens)."""
    jcfg, cfg, jp, _ = model()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 9, size=4)]
    fr = [frames(cfg, 1, 40 + i)[0] for i in range(4)]
    want = [np.asarray(JSS.greedy_generate(
        jp, jnp.asarray(p)[None], jcfg, JPOL, max_new=6, max_len=MAX_LEN,
        enc_frames=jnp.asarray(f)[None]))[0].tolist()
        for p, f in zip(prompts, fr)]
    return prompts, fr, want


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_scheduler_matches_the_reference_greedy(mode):
    """``tests/test_slot_state.py:212`` on the port: 4 requests with their
    own frames through 2 slots (an 8-token bucket; each eviction and
    refill rebuilds the slot's cross caches from the next request's
    frames): every request's tokens equal the reference's
    ``greedy_generate`` of its prompt and frames; no page leaked."""
    _, cfg, _, tp = model()
    prompts, fr, want = _trace()
    sched = S.ContinuousScheduler(
        tp, cfg, POL, batch=2, max_len=MAX_LEN, prefill_len=BUCKET,
        cache_dtype=torch.float32, cache_mode=mode, page_size=4,
        device="cpu")
    for i, (p, f) in enumerate(zip(prompts, fr)):
        sched.submit(S.Request(rid=i, prompt=p, max_new_tokens=6,
                               enc_frames=f))
    got = {r.rid: r.output.tolist() for r in sched.run()}
    assert [got[i] for i in range(4)] == want
    assert sched.stats.prefills == 4 and sched.stats.nonfinite_logits == 0
    if sched.allocator is not None:
        assert sched.allocator.in_use == 0
    # the port's own greedy generation agrees too
    for i, (p, f) in enumerate(zip(prompts, fr)):
        assert SS.greedy_generate(
            tp, torch.from_numpy(p)[None], cfg, POL, max_new=6,
            max_len=MAX_LEN, enc_frames=torch.from_numpy(f)[None]
        )[0].tolist() == want[i]


def test_refill_keeps_the_survivor_in_bits():
    """``tests/test_slot_state.py:218`` on the port: decode 2 steps,
    refill slot 0 with a third request (a new prompt and new frames),
    decode 3 more: slot 1's logits hold the same bits as a run without the
    refill (the refill writes only slot 0's cross rows)."""
    _, cfg, _, tp = model()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 7, 4)]
    fr = [torch.from_numpy(frames(cfg, 1, 50 + i)) for i in range(3)]

    def prefill_both():
        state = T.init_decode_state(cfg, 2, 32, torch.float32, device="cpu",
                                    enc_len=cfg.enc_seq)
        cur = torch.zeros((2, 1), dtype=torch.int64)
        for i in (0, 1):
            t, n = _bucketed(prompts[i])
            lg, state = SS.prefill_into_slot(tp, t, n, state, i, cfg, POL,
                                             enc_frames=fr[i])
            cur[i, 0] = lg.argmax()
        return state, cur

    def decode(state, cur, n):
        out = []
        for _ in range(n):
            lg, state = T.decode_step(tp, cur, state, cfg, POL)
            out.append(lg.clone())
            cur = lg.argmax(-1, keepdim=True)
        return state, cur, out

    state, cur = prefill_both()
    state, cur, _ = decode(state, cur, 2)
    t, n = _bucketed(prompts[2])
    lg, state = SS.prefill_into_slot(tp, t, n, state, 0, cfg, POL,
                                     enc_frames=fr[2])
    cur_a = cur.clone()
    cur_a[0, 0] = lg.argmax()
    _, _, logits_a = decode(state, cur_a, 3)
    state, cur = prefill_both()
    state, cur, _ = decode(state, cur, 2)
    _, _, logits_b = decode(state, cur, 3)
    for a, b in zip(logits_a, logits_b):
        assert torch.equal(a[1], b[1])
        assert not torch.equal(a[0], b[0])


def test_decode_step_embeds_each_slot_at_its_position():
    """Two slots prefilled to different lengths (5 and 9 tokens, their own
    frames) decode 3 steps: each step's logits equal the reference's
    ``decode_step`` on the reference's state of the same prefills, so each
    slot's token is embedded at its own ``state["pos"]`` (the learned
    positions are 10x the init's: a slot embedded elsewhere would miss by
    far more than the tolerance), and the positions advance per slot."""
    jcfg, cfg, jp, tp = model()
    lens = (5, 9)
    fr = frames(cfg, 2, 60)
    toks = tokens(cfg, (2, 12), 61)
    state = T.init_decode_state(cfg, 2, 32, torch.float32, device="cpu",
                                enc_len=cfg.enc_seq)
    jstate = JT.init_decode_state(jcfg, 2, 32, jnp.float32,
                                  enc_len=jcfg.enc_seq)
    jprefill = jax.jit(functools.partial(JSS.prefill_into_slot, cfg=jcfg,
                                         policy=JPOL))
    for i, n in enumerate(lens):
        t, _ = _bucketed(toks[i, :n], 12)
        _, state = SS.prefill_into_slot(tp, t, n, state, i, cfg, POL,
                                        enc_frames=torch.from_numpy(
                                            fr[i:i + 1]))
        _, jstate = jprefill(jp, jnp.asarray(t.numpy()), n, jstate, i,
                             enc_frames=jnp.asarray(fr[i:i + 1]))
    assert state["pos"].tolist() == list(lens)
    jdecode = jax.jit(functools.partial(JT.decode_step, cfg=jcfg,
                                        policy=JPOL))
    cur = np.array([[3], [7]], np.int32)
    for step in range(3):
        jlg, jstate = jdecode(jp, jnp.asarray(cur), jstate)
        lg, state = T.decode_step(tp, torch.from_numpy(cur), state, cfg,
                                  POL)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL,
                                   err_msg=f"step {step}")
        cur = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)
    assert state["pos"].tolist() == [n + 3 for n in lens]


def test_reset_slot_zeroes_the_cross_rows():
    """The adapter's prefill fills slot 1's cross rows in every layer and
    leaves slot 0's; ``reset_slot`` zeroes slot 1's and its position."""
    _, cfg, _, tp = model()
    ad = SlotStateAdapter(tp, cfg, POL, batch=2, max_len=32,
                          cache_dtype=torch.float32, device="cpu")
    state = ad.init_state()
    toks, n = _bucketed(np.arange(1, 6))
    ad.prefill(state, toks, n, 1,
               enc_frames=torch.from_numpy(frames(cfg, 1, 70)))
    crosses = [st["cross"] for st in state["blocks"]]
    assert len(crosses) == cfg.n_layers
    for c in crosses:
        for t in c.values():
            assert float(t[1].abs().sum()) > 0 and float(t[0].abs().sum()) == 0
    ad.reset_slot(state, 1)
    assert int(state["pos"][1]) == 0
    for c in crosses:
        for t in c.values():
            assert float(t.abs().sum()) == 0


def test_refusals_and_the_cli():
    """The prefix cache (frames break the token hash) and the cohort
    scheduler (no per-request frames) refuse whisper, and so does the
    serve CLI's cohort mode; its raw and continuous modes serve it on the
    CPU (each request its own frames), with no page leaked."""
    _, cfg, _, tp = model()
    with pytest.raises(ValueError, match="prefix_shareable"):
        S.ContinuousScheduler(tp, cfg, POL, batch=2, max_len=32,
                              cache_mode="paged", prefix_cache=True,
                              device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        S.CohortScheduler(tp, cfg, POL, batch=2, max_len=32, device="cpu")
    base = ["--device", "cpu", "--arch", ARCH, "--prompt-len", "8",
            "--new-tokens", "4", "--requests", "5"]
    with pytest.raises(SystemExit):
        serve_cli.main(base + ["--mode", "cohort"])
    ids = serve_cli.main(base + ["--mode", "raw"])
    assert ids.shape == (4, 4)
    sched = serve_cli.main(base + ["--mode", "continuous", "--cache-mode",
                                   "paged_int8", "--page-size", "4"])
    assert sched.stats.prefills == 5 and sched.allocator.in_use == 0
    assert sched.stats.state_bytes > 0 and sched.stats.cache_bytes > 0
