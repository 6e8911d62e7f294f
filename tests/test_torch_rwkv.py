"""The port's RWKV-6 serving slice against the JAX package at f32, on the
same weights: the time mix and channel mix, the full forward, prefill and
decode with every recurrent state row, greedy generation, the slot prefill's
exactness contract, the slot adapter, ``ContinuousScheduler`` and the serve
CLI.  On CPU tensors ``kops.wkv6`` runs the plain chunked recurrence; the
reference takes its jnp ``wkv6_chunked`` there."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.amp import make_policy as jmake_policy
from repro.models import rwkv as JRW
from repro.models import transformer as JT
from repro.serve import scheduler as JS
from repro.serve import serve_step as JSS
from repro.serve.slot_state import SlotStateAdapter as JAdapter
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.serve import scheduler as S
from repro_torch.serve import serve_step as SS
from repro_torch.serve.slot_state import SlotStateAdapter
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ARCH = "rwkv6-1.6b"
JCFG = jsmoke(jget_config(ARCH), n_blocks=2)
CFG = smoke_variant(get_config(ARCH), n_blocks=2)
JPOL, POL = jmake_policy("f32"), make_policy("f32")
# f32 logits of a 2-layer model: the two frameworks differ only in
# summation order; the tolerance of tests/test_torch_serve.py
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_KEYS = ("tm_shift", "wkv", "cm_shift")


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(lambda key: JT.init_model(key, JCFG)[0])(
        jax.random.PRNGKey(0))
    # the reference initialises the mix and bonus vectors to constants
    # (zeros, ones, -6); perturb them so a swapped mix or a dropped bias
    # shows in the logits
    rng = np.random.default_rng(5)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    for key in ("maa_x", "maa_wkvrg", "decay", "ln_x_scale", "ln_x_bias"):
        leaf = np_params["blocks"][0]["mixer"][key]
        np_params["blocks"][0]["mixer"][key] = (
            leaf + 0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)
    for key in ("maa_k", "maa_r"):
        leaf = np_params["blocks"][0]["mlp"][key]
        np_params["blocks"][0]["mlp"][key] = (
            0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    return jp, bridge.params_from_jax(np_params, CFG, device="cpu")


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree["blocks"][0])


def _np(t):
    return t.detach().numpy()


def test_config_and_param_count_match_the_reference():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.rwkv_n_heads, cfg.rwkv_head_size,
            cfg.d_ff, cfg.vocab_size) == (24, 2048, 32, 64, 7168, 65536)
    assert cfg.param_count() == jget_config(ARCH).param_count()
    assert (CFG.d_model, CFG.rwkv_n_heads) == (256, 4)
    assert dataclasses.astuple(CFG.decode_caps) == \
        dataclasses.astuple(JCFG.decode_caps)


def test_params_from_jax_round_trips_bit_exactly(weights):
    jp, tp = weights
    mix = tp["blocks"][0]["mixer"]
    assert mix["maa_w2"].shape == (5, 32, CFG.d_model)
    assert mix["maa_wkvrg"].shape == (5, CFG.d_model)
    assert mix["u"].shape == (CFG.rwkv_n_heads, CFG.rwkv_head_size)
    back = bridge.params_to_numpy(tp, CFG)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jp))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        assert flat_b[path].dtype == leaf.dtype
        assert np.array_equal(flat_b[path], leaf), path


def test_init_model_is_seeded_with_the_reference_layout():
    a = T.init_model(CFG, seed=3, device="cpu")
    b = T.init_model(CFG, seed=3, device="cpu")
    jp = jax.jit(lambda key: JT.init_model(key, JCFG)[0])(
        jax.random.PRNGKey(0))
    shapes = lambda tree, skip: {
        jax.tree_util.keystr(path): tuple(leaf.shape)[skip:]
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes(a["blocks"][0], 0) == shapes(jp["blocks"][0], 1)
    assert torch.equal(a["blocks"][1]["mixer"]["u"],
                       b["blocks"][1]["mixer"]["u"])
    assert float(a["blocks"][0]["mixer"]["decay"][0]) == -6.0


@pytest.mark.parametrize("with_state,valid", [(False, None), (True, None),
                                              (True, [5, 9])])
def test_time_and_channel_mix_match_jax(weights, with_state, valid):
    """One layer's mixers on a (2, 9) input: from zero, from a carried
    state, and right-padded with per-row lengths (masked sequential
    scan); outputs and new state rows within LOGIT_TOL."""
    jp, tp = weights
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, CFG.d_model)).astype(np.float32)
    jl, tl = _layer(jp, 1), tp["blocks"][1]
    jst = tst = None
    if with_state:
        h, hs = CFG.rwkv_n_heads, CFG.rwkv_head_size
        st = {"tm_shift": rng.standard_normal((2, 1, CFG.d_model)),
              "wkv": 0.1 * rng.standard_normal((2, h, hs, hs)),
              "cm_shift": rng.standard_normal((2, 1, CFG.d_model))}
        st = {k: v.astype(np.float32) for k, v in st.items()}
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
    jvl = None if valid is None else jnp.asarray(valid, jnp.int32)
    tvl = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    jy, jns = JRW.apply_time_mix(jl["mixer"], jnp.asarray(x), JCFG, JPOL,
                                 state=jst, return_state=True, valid_len=jvl)
    ty, tns = RW.apply_time_mix(tl["mixer"], torch.from_numpy(x), CFG, POL,
                                state=tst, return_state=True, valid_len=tvl)
    keep = np.ones((2, 9), bool) if valid is None else \
        np.arange(9)[None] < np.asarray(valid)[:, None]
    np.testing.assert_allclose(_np(ty)[keep], np.asarray(jy)[keep],
                               **LOGIT_TOL)
    for key in ("tm_shift", "wkv"):
        np.testing.assert_allclose(_np(tns[key]), np.asarray(jns[key]),
                                   **LOGIT_TOL)
    jy, jns = JRW.apply_channel_mix(jl["mlp"], jnp.asarray(x), JCFG, JPOL,
                                    state=jst, return_state=True,
                                    valid_len=jvl)
    ty, tns = RW.apply_channel_mix(tl["mlp"], torch.from_numpy(x), CFG, POL,
                                   state=tst, return_state=True,
                                   valid_len=tvl)
    np.testing.assert_allclose(_np(ty)[keep], np.asarray(jy)[keep],
                               **LOGIT_TOL)
    np.testing.assert_array_equal(_np(tns["cm_shift"]),
                                  np.asarray(jns["cm_shift"]))


def test_apply_lm_matches_jax(weights):
    """Full forward at S = 128: two chunks of 64 through the chunked
    recurrence (``kops.wkv6``'s plain version against ``wkv6_chunked``)."""
    jp, tp = weights
    toks = np.random.default_rng(2).integers(
        0, CFG.vocab_size, (2, 128)).astype(np.int32)
    want, _ = JT.apply_lm(jp, jnp.asarray(toks), JCFG, JPOL)
    got = T.apply_lm(tp, torch.from_numpy(toks), CFG, POL)
    assert got.shape == (2, 128, CFG.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)


def _assert_states_close(tstate, jstate, row=None):
    for li in range(CFG.n_layers):
        jst = _layer({"blocks": jstate["blocks"]}, li)
        for key in STATE_KEYS:
            got = _np(tstate["blocks"][li][key])
            want = np.asarray(jst[key])
            if row is not None:
                got, want = got[row], want[row]
            np.testing.assert_allclose(got, want, err_msg=f"{li} {key}",
                                       **LOGIT_TOL)


@pytest.mark.parametrize("lengths", [None, [70, 128]])
def test_prefill_and_decode_match_jax(weights, lengths):
    """Prefill of a (2, 128) prompt -- unmasked (the chunked recurrence)
    and right-padded (the masked sequential scan) -- then 4 decode steps
    fed the same tokens: logits and every recurrent state row within
    LOGIT_TOL after each step."""
    jp, tp = weights
    prompt = np.random.default_rng(4).integers(
        0, CFG.vocab_size, (2, 128)).astype(np.int32)
    jstate = JT.init_decode_state(JCFG, 2, 140, jnp.float32)
    tstate = T.init_decode_state(CFG, 2, 140, torch.float32, device="cpu")
    kw_j = kw_t = {}
    if lengths is not None:
        kw_j = {"lengths": jnp.asarray(lengths, jnp.int32)}
        kw_t = {"lengths": torch.tensor(lengths, dtype=torch.int32)}
    jl, jstate = JT.prefill(jp, jnp.asarray(prompt), JCFG, JPOL,
                            state=jstate, **kw_j)
    tl, tstate = T.prefill(tp, torch.from_numpy(prompt), CFG, POL,
                           state=tstate, **kw_t)
    for _ in range(4):
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
        _assert_states_close(tstate, jstate)
        assert tstate["pos"].tolist() == np.asarray(jstate["pos"]).tolist()
        tok = np.array(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok[:, 0])
        jl, jstate = JT.decode_step(jp, jnp.asarray(tok), jstate, JCFG, JPOL,
                                    moe_impl="dense")
        tl, tstate = T.decode_step(tp, torch.from_numpy(tok), tstate, CFG,
                                   POL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    _assert_states_close(tstate, jstate)


def test_unmasked_prefill_off_the_chunk_grid_raises(weights):
    """S = 100 > 64 and not a multiple of it: the port raises ValueError
    naming the constraint, the reference asserts in ``wkv6_chunked``."""
    jp, tp = weights
    toks = np.zeros((1, 100), np.int32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        T.prefill(tp, torch.from_numpy(toks), CFG, POL,
                  state=T.init_decode_state(CFG, 1, 128, device="cpu"))
    with pytest.raises(AssertionError):
        JT.prefill(jp, jnp.asarray(toks), JCFG, JPOL,
                   state=JT.init_decode_state(JCFG, 1, 128))


def test_greedy_generate_matches_jax(weights):
    jp, tp = weights
    prompt = np.random.default_rng(9).integers(
        0, CFG.vocab_size, (2, 7)).astype(np.int32)
    want = JSS.greedy_generate(jp, jnp.asarray(prompt), JCFG, JPOL,
                               max_new=5, max_len=16)
    got = SS.greedy_generate(tp, torch.from_numpy(prompt), CFG, POL,
                             max_new=5, max_len=16)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_padded_slot_prefill_state_is_bit_identical(weights):
    """The exactness contract: a right-padded prefill into slot 1 of a
    live state leaves that slot's logits and recurrent rows bit-identical
    to an unpadded prefill of the true prompt (the same implementation),
    and slot 0 untouched; the rows also match the reference's slot
    prefill within LOGIT_TOL."""
    jp, tp = weights
    rng = np.random.default_rng(0)
    bucket = 16
    for plen in (3, 11, 16):
        prompt = rng.integers(1, CFG.vocab_size, size=plen, dtype=np.int32)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = prompt
        state = T.init_decode_state(CFG, 2, 32, torch.float32, device="cpu")
        lg_pad, state = SS.prefill_into_slot(tp, torch.from_numpy(toks), plen,
                                             state, 1, CFG, POL)
        ref = T.init_decode_state(CFG, 1, 32, torch.float32, device="cpu")
        lg_ref, ref = T.prefill(tp, torch.from_numpy(prompt)[None], CFG, POL,
                                state=ref,
                                lengths=torch.tensor([plen], dtype=torch.int32))
        assert torch.equal(lg_pad, lg_ref[0])
        assert state["pos"].tolist() == [0, plen]
        for st, st_ref in zip(state["blocks"], ref["blocks"]):
            for key in STATE_KEYS:
                assert torch.equal(st[key][1], st_ref[key][0]), key
                assert not st[key][0].any(), key
        jstate = JT.init_decode_state(JCFG, 2, 32, jnp.float32)
        jl, jstate = JSS.prefill_into_slot(jp, jnp.asarray(toks), plen,
                                           jstate, 1, JCFG, JPOL)
        np.testing.assert_allclose(_np(lg_pad), np.asarray(jl), **LOGIT_TOL)
        _assert_states_close(state, jstate, row=1)


def test_slot_prefill_starts_from_a_fresh_row(weights):
    """A slot prefill starts from the zero state whatever the slot's rows
    hold (the reference prefills into a fresh row): decode steps over the
    whole batch advance an empty slot's rows, so its next tenant would
    otherwise inherit them.  Rows dirtied with noise, prefill into slot 1:
    its logits and rows equal, bit for bit, those of the same prefill
    into a zero state; slot 0's noise stays."""
    _, tp = weights
    toks = torch.zeros((1, 16), dtype=torch.int32)
    toks[0, :7] = torch.arange(3, 10)
    gen = torch.Generator().manual_seed(3)
    fresh = T.init_decode_state(CFG, 2, 32, torch.float32, device="cpu")
    dirty = T.init_decode_state(CFG, 2, 32, torch.float32, device="cpu")
    for st in dirty["blocks"]:
        for key in STATE_KEYS:
            st[key].copy_(torch.randn(st[key].shape, generator=gen))
    noise = [st[key][0].clone() for st in dirty["blocks"] for key in STATE_KEYS]
    lg_fresh, fresh = SS.prefill_into_slot(tp, toks, 7, fresh, 1, CFG, POL)
    lg_dirty, dirty = SS.prefill_into_slot(tp, toks, 7, dirty, 1, CFG, POL)
    assert torch.equal(lg_dirty, lg_fresh)
    for st, st_fresh in zip(dirty["blocks"], fresh["blocks"]):
        for key in STATE_KEYS:
            assert torch.equal(st[key][1], st_fresh[key][1]), key
    assert all(torch.equal(st[key][0], n) for n, (st, key) in zip(
        noise, ((st, key) for st in dirty["blocks"] for key in STATE_KEYS)))


def test_reset_slot_zeroes_the_recurrent_rows(weights):
    _, tp = weights
    adapter = SlotStateAdapter(tp, CFG, POL, batch=2, max_len=32,
                               cache_dtype=torch.float32, device="cpu")
    state = adapter.init_state()
    toks = torch.zeros((1, 8), dtype=torch.int32)
    toks[0, :5] = torch.arange(1, 6)
    _, state = adapter.prefill(state, toks, 5, 1)
    assert all(st[k][1].any() for st in state["blocks"] for k in STATE_KEYS)
    state = adapter.reset_slot(state, 1)
    for st in state["blocks"]:
        for key in STATE_KEYS:
            assert not st[key].any(), key
    assert state["pos"].tolist() == [0, 0]


def test_state_and_cache_bytes_match_jax_adapter(weights):
    """rwkv keeps no KV cache; its recurrent rows are the state bytes, the
    same total as the reference's stacked leaves."""
    jp, tp = weights
    for batch in (2, 4):
        jad = JAdapter(jp, JCFG, JPOL, batch=batch, max_len=32)
        tad = SlotStateAdapter(tp, CFG, POL, batch=batch, max_len=32,
                               device="cpu")
        assert tad.cache_bytes() == jad.cache_bytes() == 0
        assert tad.state_bytes() == jad.state_bytes() > 0
    h, hs, d = CFG.rwkv_n_heads, CFG.rwkv_head_size, CFG.d_model
    assert tad.state_bytes() == 4 * CFG.n_layers * (2 * d + h * hs * hs) * 4
    full = get_config(ARCH)
    per_slot = SlotStateAdapter(None, full, POL, batch=1, max_len=1,
                                device="meta").state_bytes()
    assert per_slot == 24 * (2 * 2048 * 4 + 32 * 64 * 64 * 4)


def test_scheduler_matches_jax(weights):
    """Per-request tokens of ContinuousScheduler identical to the JAX
    scheduler's on one seeded trace of mixed lengths: every admission is
    a masked slot prefill, refills reuse zeroed slots."""
    jp, tp = weights
    rng = np.random.default_rng(7)
    trace = [(rng.integers(1, CFG.vocab_size, size=int(rng.integers(3, 16)))
              .astype(np.int32), int(rng.integers(2, 7))) for _ in range(5)]
    kw = dict(batch=2, max_len=32, prefill_len=16)
    jsched = JS.ContinuousScheduler(jp, JCFG, JPOL, cache_dtype=jnp.float32,
                                    **kw)
    tsched = S.ContinuousScheduler(tp, CFG, POL, cache_dtype=torch.float32,
                                   device="cpu", **kw)
    for i, (prompt, new) in enumerate(trace):
        jsched.submit(JS.Request(rid=i, prompt=prompt, max_new_tokens=new))
        tsched.submit(S.Request(rid=i, prompt=prompt, max_new_tokens=new))
    want = {r.rid: r.output.tolist() for r in jsched.run()}
    got = {r.rid: r.output.tolist() for r in tsched.run()}
    assert got == want
    assert tsched.stats.useful_tokens == jsched.stats.useful_tokens
    assert tsched.stats.prefills == 5 and tsched.stats.nonfinite_logits == 0
    assert tsched.stats.cache_bytes == 0
    assert tsched.stats.state_bytes == jsched.stats.state_bytes
    with pytest.raises(ValueError, match="pageable"):
        S.ContinuousScheduler(tp, CFG, POL, cache_mode="paged", device="cpu",
                              **kw)


@pytest.mark.parametrize("mode", ["raw", "continuous"])
def test_serve_cli_runs_rwkv_on_cpu(mode):
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", ARCH, "--mode", mode,
                      "--requests", "3", "--prompt-len", "16",
                      "--new-tokens", "4"])
    if mode == "raw":
        assert out.shape == (4, 4)
    else:
        assert out.stats.prefills == 3 and out.stats.nonfinite_logits == 0
        assert out.stats.cache_bytes == 0 and out.stats.state_bytes > 0
