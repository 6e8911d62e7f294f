"""The hybrid jamba-1.5-large-398b served by the port's scheduler, at f32
(``tests/torch_jamba.py``: the model, weights and tolerances):
``ContinuousScheduler`` in ``contiguous``, ``paged`` and ``paged_int8``
modes against greedy generation and the reference's scheduler, the
adapter's slot rows and footprints, the refusals and the serve and
profile CLIs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serve import scheduler as JS
from repro.serve.slot_state import SlotStateAdapter as JAdapter
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.serve import scheduler as S
from repro_torch.serve import serve_step as SS
from repro_torch.serve.slot_state import SlotStateAdapter
from torch_jamba import ARCH, JPOL, POL, RECURRENT, model, paged_cfg
import torch_threads  # noqa: F401  (one PyTorch thread a worker)


# ---------------------------------------------------------------------------
# the scheduler and the adapter
# ---------------------------------------------------------------------------

def _trace(cfg, seed=2, n=5, hi=13):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, cfg.vocab_size, int(rng.integers(3, hi)))
             .astype(np.int32), int(rng.integers(2, 7))) for _ in range(n)]


def _serve(mod, sched, trace):
    for i, (prompt, new) in enumerate(trace):
        sched.submit(mod.Request(rid=i, prompt=prompt, max_new_tokens=new))
    return {r.rid: r.output.tolist() for r in sched.run()}


@pytest.mark.parametrize("mode", ["contiguous", "paged", "paged_int8"])
def test_continuous_scheduler_matches_greedy(mode):
    """tests/test_slot_state.py:202 on the port, in every cache mode, on the
    4-layer cut: 5 requests of 3-12 prompt tokens and 2-6 new through 2
    slots (a 16-token bucket; evictions free the pages and zero the mamba
    rows, refills rebuild both).  With f32 pages each request's tokens
    equal the port's greedy generation of its prompt; with int8 pages
    they equal the reference scheduler's on the same trace.  Both
    footprints are non-zero and equal the reference adapter's."""
    jcfg, cfg, jp, tp = model(4)
    kw = dict(batch=2, max_len=32, prefill_len=16, cache_mode=mode,
              page_size=4)
    sched = S.ContinuousScheduler(tp, cfg, POL, cache_dtype=torch.float32,
                                  device="cpu", **kw)
    trace = _trace(cfg)
    got = _serve(S, sched, trace)
    assert len(got) == len(trace) and sched.stats.prefills == len(trace)
    assert sched.stats.nonfinite_logits == 0
    if mode == "paged_int8":
        jsched = JS.ContinuousScheduler(jp, jcfg, JPOL,
                                        cache_dtype=jnp.float32, **kw)
        assert got == _serve(JS, jsched, trace)
    else:
        for rid, (prompt, new) in enumerate(trace):
            want = SS.greedy_generate(tp, torch.from_numpy(prompt)[None],
                                      cfg, POL, max_new=new, max_len=32)
            assert got[rid] == want[0].tolist(), rid
    if sched.allocator is not None:
        assert sched.allocator.in_use == 0
    st = sched.stats
    assert st.state_bytes > 0 and st.cache_bytes > 0
    jad = JAdapter(jp, jcfg, JPOL, batch=2, max_len=32,
                   cache_dtype=jnp.float32,
                   paged_cfg=paged_cfg(JT, mode, num_pages=sched.num_pages))
    assert (st.state_bytes, st.cache_bytes) == (jad.state_bytes(),
                                                jad.cache_bytes())


@pytest.mark.parametrize("mode", ["paged", "paged_int8"])
def test_slot_refilled_after_empty_decode_steps(mode):
    """A slot that sits empty through decode steps before it is refilled:
    a pool of 6 pages of 4 tokens takes the first request (12 prompt
    tokens, 4 pages, a fifth as it grows) but not the second (3 pages), so
    slot 1 waits for the pool ("pool dry") through the first request's 5
    decode steps, which advance its mamba rows, and is then refilled by
    the third; no preemption.  Each request's tokens equal the reference
    scheduler's on the same trace and pool, and with f32 pages the port's
    greedy generation of its prompt."""
    jcfg, cfg, jp, tp = model(4)
    rng = np.random.default_rng(4)
    trace = [(rng.integers(1, cfg.vocab_size, n).astype(np.int32), new)
             for n, new in ((12, 6), (10, 4), (5, 3))]
    kw = dict(batch=2, max_len=32, prefill_len=16, cache_mode=mode,
              page_size=4, num_pages=7)
    sched = S.ContinuousScheduler(tp, cfg, POL, cache_dtype=torch.float32,
                                  device="cpu", **kw)
    got = _serve(S, sched, trace)
    st = sched.stats
    assert st.preemptions == 0 and st.prefills == len(trace)
    assert st.wasted_slots >= 5 and sched.allocator.in_use == 0
    jsched = JS.ContinuousScheduler(jp, jcfg, JPOL, cache_dtype=jnp.float32,
                                    **kw)
    assert got == _serve(JS, jsched, trace)
    if mode == "paged":
        for rid, (prompt, new) in enumerate(trace):
            want = SS.greedy_generate(tp, torch.from_numpy(prompt)[None],
                                      cfg, POL, max_new=new, max_len=32)
            assert got[rid] == want[0].tolist(), rid


def test_adapter_slot_rows_and_refusals():
    """The adapter sees the mamba rows as slot state (``has_slot_state``,
    ``reset_slot`` zeroes them and the position, the pages stay), its
    footprints split into pages + table and mamba rows; the prefix cache
    is refused (jamba is not ``prefix_shareable``, as the reference
    refuses it); the suffix prefill refuses the hybrid; training takes
    its mamba layers (tests/test_torch_jamba_train.py)."""
    _, cfg, _, tp = model(4)
    paged = T.PagedCacheConfig(page_size=4, num_pages=17)
    ad = SlotStateAdapter(tp, cfg, POL, batch=2, max_len=32,
                          cache_dtype=torch.float32, paged_cfg=paged,
                          device="cpu")
    assert ad.has_slot_state
    din, n, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    assert ad.state_bytes() == 3 * 2 * ((dc - 1) * din + din * n) * 4
    kv = cfg.n_kv_heads * cfg.head_dim
    assert ad.cache_bytes() == 2 * 17 * 4 * kv * 4 + 2 * 8 * 4
    state = ad.init_state()
    ad.write_table_row(state, 1, [1, 2, 3, 4])
    toks = torch.zeros((1, 8), dtype=torch.int32)
    toks[0, :5] = torch.arange(1, 6)
    _, state = ad.prefill(state, toks, 5, 1)
    assert all(st[k][1].any() for st in state["blocks"][1:]
               for k in RECURRENT)
    pages = state["blocks"][0]["cache"]["k_pages"].clone()
    state = ad.reset_slot(state, 1)
    assert not any(st[k].any() for st in state["blocks"][1:]
                   for k in RECURRENT)
    assert state["pos"].tolist() == [0, 0]
    assert torch.equal(state["blocks"][0]["cache"]["k_pages"], pages)
    with pytest.raises(ValueError, match="prefix_shareable"):
        S.ContinuousScheduler(tp, cfg, POL, batch=2, max_len=32,
                              cache_mode="paged", prefix_cache=True,
                              device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        T.prefill_suffix(tp, toks, 4, 2, cfg, POL, state=state)
    api.check_trainable(cfg)
    assert callable(api.make_loss_fn(cfg, POL))


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,cache_mode", [("continuous", "paged"),
                                             ("raw", "contiguous")])
def test_serve_cli_runs_on_cpu(mode, cache_mode, caplog):
    """``launch/serve.py --arch jamba-1.5-large-398b`` at the smoke size:
    continuous with paged attention beside the mamba rows (both
    footprints logged), and raw (the unmasked chunked prefill)."""
    from repro_torch.launch import serve
    args = ["--device", "cpu", "--arch", ARCH, "--mode", mode,
            "--cache-mode", cache_mode, "--requests", "3", "--prompt-len",
            "16", "--new-tokens", "4"]
    with caplog.at_level("INFO", logger="repro_torch.serve"):
        out = serve.main(args)
    text = caplog.text
    assert ARCH in text
    if mode == "raw":
        assert out.shape == (4, 4) and "generated ids" in text
    else:
        assert "3 requests done" in text and "0 pages leaked" in text
        assert out.stats.state_bytes > 0 and out.stats.cache_bytes > 0
        assert out.allocator.in_use == 0


def test_profile_serve_takes_the_hybrid():
    """``profile_serve --arch jamba-1.5-large-398b --full-width --layers
    4`` parses, cuts the block to its first 4 layers and then asks for the
    card it measures; its decode split spans the mamba mixer's parts."""
    from repro_torch.launch import profile_serve
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_serve.main(["--arch", ARCH, "--full-width", "--layers", "4"])
    assert {"mamba_in_proj", "mamba_conv", "mamba_scan",
            "mamba_out_proj"} <= set(profile_serve.SPANS)
