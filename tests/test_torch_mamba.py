"""The port's mamba mixer (``repro_torch/models/mamba.py``) against the
JAX package's (``repro/models/mamba.py``) at f32, on jamba's smoke
variant at d_model 64 (d_inner 128, N 16, d_conv 4, dt rank 4), the
sizes of tests/test_mixers.py's ``TestMamba``: the init, the causal conv,
the chunked and the sequential scans, decode, the state handoff at a
chunk boundary and the masked prefill's exactness.

Weights are the reference's init carried across as numpy, with in_proj,
x_proj and out_proj scaled up (25x, 10x, 100x) and conv_b and d_skip
drawn, so that outputs are O(1) (at the init's own scales the mixer's
output is ~5e-5, under any absolute tolerance) and neither the conv bias
nor the skip can agree by being zeros or ones.  Outputs and states are
held within test_mixers.py's rtol 1e-4 / atol 1e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.amp import make_policy as jmake_policy
from repro.models import mamba as JMB
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import mamba as MB
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ARCH = "jamba-1.5-large-398b"
JCFG = jsmoke(jget_config(ARCH), d_model=64)
CFG = smoke_variant(get_config(ARCH), d_model=64)
JPOL, POL = jmake_policy("f32"), make_policy("f32")
TOL = dict(rtol=1e-4, atol=1e-5)
GAINS = {"in_proj": 25.0, "x_proj": 10.0, "out_proj": 100.0}


@functools.lru_cache(maxsize=None)
def _weights():
    """(JAX params, port params): the same numpy values on both sides."""
    jp = jax.jit(lambda k: JMB.init_mamba(k, JCFG)[0])(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    npp = {k: (np.asarray(v) * GAINS.get(k, 1.0)).astype(np.float32)
           for k, v in jp.items()}
    npp["conv_b"] = (0.1 * rng.standard_normal(
        npp["conv_b"].shape)).astype(np.float32)
    npp["d_skip"] = (1 + 0.1 * rng.standard_normal(
        npp["d_skip"].shape)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in npp.items()},
            {k: torch.from_numpy(v.copy()) for k, v in npp.items()})


def _x(shape, seed=1):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _jstate(state):
    return {k: jnp.asarray(v.numpy()) for k, v in state.items()}


# ---------------------------------------------------------------------------
# init and state
# ---------------------------------------------------------------------------

def test_init_shapes_and_deterministic_leaves():
    """Every leaf has the reference's shape; the deterministic leaves equal
    the reference's (S4D-real ``a_log``, ``d_skip`` ones, ``conv_b``
    zeros); ``softplus(dt_bias)`` lies in [1e-3, 1e-1], as the reference's
    inverse-softplus init puts it; a bf16 init stores bf16 leaves; the
    state is fp32 (B, dc - 1, din) and (B, din, N)."""
    jp = jax.jit(lambda k: JMB.init_mamba(k, JCFG)[0])(jax.random.PRNGKey(0))
    own = MB.init_mamba(CFG, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    for k in ("a_log", "d_skip", "conv_b"):
        np.testing.assert_array_equal(own[k].numpy(), np.asarray(jp[k]))
    dt = torch.nn.functional.softplus(own["dt_bias"])
    assert 1e-3 * (1 - 1e-5) <= float(dt.min()) <= float(dt.max()) <= \
        1e-1 * (1 + 1e-5)
    out_std = float(own["out_proj"].std())
    assert 0.5 < out_std / (0.02 / np.sqrt(2 * CFG.n_layers)) < 1.2
    bf = MB.init_mamba(CFG, torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in bf.values())
    st = MB.init_mamba_state(CFG, 3)
    jst = JMB.init_mamba_state(JCFG, 3)
    for k in ("conv", "ssm"):
        assert tuple(st[k].shape) == jst[k].shape
        assert st[k].dtype == torch.float32 and not st[k].any()


# ---------------------------------------------------------------------------
# the causal conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("valid_len", [None, 1, 2, 3, 7, (2, 9)])
def test_causal_conv_matches_jax(with_state, valid_len):
    """``_causal_conv`` on (2, 9, din): y and the carried window equal the
    reference's, from zeros or a drawn state, unmasked or with true
    lengths -- 1 and 2 (shorter than dc - 1 = 3: the window reaches back
    into the prepended context), 3, 7, and one per row."""
    jp, tp = _weights()
    din = CFG.mamba_d_inner
    x = _x((2, 9, din), 4)
    w = _x((CFG.mamba_d_conv, din), 5)
    b = _x((din,), 6)
    state = _x((2, CFG.mamba_d_conv - 1, din), 7) if with_state else None
    vl = None if valid_len is None else np.asarray(valid_len, np.int32)
    jy, jst = JMB._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if state is None else jnp.asarray(state),
        valid_len=None if vl is None else jnp.asarray(vl))
    ty, tst = MB._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if state is None else torch.from_numpy(state),
        valid_len=None if vl is None else torch.from_numpy(vl))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def test_causal_conv_short_prompt_carries_the_context():
    """A 2-token prompt after a state: the new window is the state's last
    row then the two tokens, as an unpadded run carries it."""
    din, dc = CFG.mamba_d_inner, CFG.mamba_d_conv
    x = torch.from_numpy(_x((1, 5, din), 8))
    state = torch.from_numpy(_x((1, dc - 1, din), 9))
    w = torch.ones((dc, din))
    _, st = MB._causal_conv(x, w, torch.zeros(din), state, valid_len=2)
    assert torch.equal(st[0], torch.cat([state[0, -1:], x[0, :2]]))
    _, st_raw = MB._causal_conv(x[:, :2], w, torch.zeros(din), state)
    assert torch.equal(st, st_raw)


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------

def _coefs(b=2, s=64, seed=10):
    """Decay coefficients in (0, 1) and inputs of the scale a mixer
    forms, (B, S, din, N) fp32, and a drawn h0."""
    rng = np.random.default_rng(seed)
    din, n = CFG.mamba_d_inner, CFG.mamba_d_state
    a = np.exp(-rng.uniform(0.0, 0.2, (b, s, din, n))).astype(np.float32)
    bx = (0.1 * rng.standard_normal((b, s, din, n))).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((b, din, n))).astype(np.float32)
    return a, bx, h0


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssm_chunked_matches_both_reference_forms(chunk):
    """The doubling scan by chunks of 8, 16 and 64 over S 64: ys and the
    final state against the reference's ``_ssm_chunked`` (associative scan
    in chunks) and ``_ssm_sequential``."""
    a, bx, h0 = _coefs()
    ys, h = MB._ssm_chunked(*map(torch.from_numpy, (a, bx, h0)), chunk)
    for jys, jh in (JMB._ssm_chunked(jnp.asarray(a), jnp.asarray(bx),
                                     jnp.asarray(h0), chunk),
                    JMB._ssm_sequential(jnp.asarray(a), jnp.asarray(bx),
                                        jnp.asarray(h0))):
        _close(ys, jys)
        _close(h, jh)


def test_ssm_sequential_matches_both_reference_forms():
    a, bx, h0 = _coefs(s=24, seed=11)
    ys, h = MB._ssm_sequential(*map(torch.from_numpy, (a, bx, h0)))
    for jys, jh in (JMB._ssm_sequential(jnp.asarray(a), jnp.asarray(bx),
                                        jnp.asarray(h0)),
                    JMB._ssm_chunked(jnp.asarray(a), jnp.asarray(bx),
                                     jnp.asarray(h0), 8)):
        _close(ys, jys)
        _close(h, jh)


def test_ssm_chunked_refuses_a_ragged_sequence():
    """S 24 in chunks of 16 raises, as the reference asserts; a chunk
    longer than S is cut to S."""
    a, bx, h0 = map(torch.from_numpy, _coefs(s=24, seed=12))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        MB._ssm_chunked(a, bx, h0, 16)
    ys, _ = MB._ssm_chunked(a, bx, h0, 128)
    assert ys.shape == a.shape
    with pytest.raises(ValueError, match="multiple of the chunk"):
        MB.apply_mamba(_weights()[1], torch.zeros((1, 24, CFG.d_model)),
                       CFG, POL, chunk=16)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_apply_mamba_chunked_and_sequential_match_jax(chunk):
    """tests/test_mixers.py's chunked-equals-sequential on the port: the
    mixer over (2, 64, d) by chunks of ``chunk`` and sequentially, each
    against the reference's chunked and sequential outputs and states."""
    jp, tp = _weights()
    x = _x((2, 64, CFG.d_model))
    jy, jst = JMB.apply_mamba(jp, jnp.asarray(x), JCFG, JPOL,
                              return_state=True, chunk=chunk)
    jy_s, jst_s = JMB.apply_mamba(jp, jnp.asarray(x), JCFG, JPOL,
                                  return_state=True, use_chunked=False)
    for kw in (dict(chunk=chunk), dict(use_chunked=False)):
        y, st = MB.apply_mamba(tp, torch.from_numpy(x), CFG, POL,
                               return_state=True, **kw)
        for want, wst in ((jy, jst), (jy_s, jst_s)):
            _close(y, want)
            _close(st["ssm"], wst["ssm"])
            _close(st["conv"], wst["conv"])


def test_decode_equals_the_full_forward():
    """16 single-token steps from the zero state equal the full forward
    (test_mixers.py's 1e-4), and each step equals the reference's decode
    step from the same state."""
    jp, tp = _weights()
    b, s = 2, 16
    x = _x((b, s, CFG.d_model), 2)
    full, _ = MB.apply_mamba(tp, torch.from_numpy(x), CFG, POL,
                             return_state=True)
    state, outs = MB.init_mamba_state(CFG, b), []
    for t in range(s):
        xt = torch.from_numpy(x[:, t:t + 1])
        jy, jst = JMB.apply_mamba(jp, jnp.asarray(x[:, t:t + 1]), JCFG,
                                  JPOL, state=_jstate(state),
                                  return_state=True)
        y, state = MB.apply_mamba(tp, xt, CFG, POL, state=state,
                                  return_state=True)
        _close(y, jy)
        _close(state["ssm"], jst["ssm"])
        _close(state["conv"], jst["conv"])
        outs.append(y)
    _close(torch.cat(outs, 1), full.numpy(), rtol=1e-4, atol=1e-4)


def test_state_handoff_at_a_chunk_boundary():
    """Prefill the first 16 of 32 tokens, hand the state to the second 16:
    the outputs equal the full forward's, and the handed state equals the
    reference's."""
    jp, tp = _weights()
    x = _x((1, 32, CFG.d_model), 3)
    full, _ = MB.apply_mamba(tp, torch.from_numpy(x), CFG, POL,
                             return_state=True, chunk=16)
    y1, st = MB.apply_mamba(tp, torch.from_numpy(x[:, :16]), CFG, POL,
                            return_state=True, chunk=16)
    y2, _ = MB.apply_mamba(tp, torch.from_numpy(x[:, 16:]), CFG, POL,
                           state=st, return_state=True, chunk=16)
    _close(torch.cat([y1, y2], 1), full.numpy(), rtol=1e-4, atol=1e-4)
    _, jst = JMB.apply_mamba(jp, jnp.asarray(x[:, :16]), JCFG, JPOL,
                             return_state=True, chunk=16)
    _close(st["ssm"], jst["ssm"])


@pytest.mark.parametrize("plen", [3, 7, 11, 16])
def test_masked_prefill_state_is_bit_identical(plen):
    """The exactness contract at the mixer: a prompt right-padded to a
    16-token bucket (pads drawn, not zeros) with ``valid_len`` leaves
    ``conv`` and ``ssm`` bit-identical to an unpadded masked prefill of
    the true prompt, from zeros and from a carried state; the outputs at
    true positions are the same bits; and the state matches the
    reference's masked prefill within TOL."""
    jp, tp = _weights()
    x = torch.from_numpy(_x((1, 16, CFG.d_model), 20 + plen))
    vl = torch.tensor([plen], dtype=torch.int32)
    _, carried = MB.apply_mamba(tp, torch.from_numpy(
        _x((1, 5, CFG.d_model), 30)), CFG, POL, return_state=True)
    for st0 in (MB.init_mamba_state(CFG, 1), carried):
        y_pad, pad = MB.apply_mamba(tp, x, CFG, POL, state=st0,
                                    return_state=True, valid_len=vl)
        y_raw, raw = MB.apply_mamba(tp, x[:, :plen], CFG, POL, state=st0,
                                    return_state=True, valid_len=vl)
        for k in ("conv", "ssm"):
            assert torch.equal(pad[k], raw[k]), k
        assert torch.equal(y_pad[:, :plen], y_raw)
        _, jst = JMB.apply_mamba(jp, jnp.asarray(x.numpy()), JCFG, JPOL,
                                 state=_jstate(st0), return_state=True,
                                 valid_len=jnp.asarray(vl.numpy()))
        _close(pad["ssm"], jst["ssm"])
        _close(pad["conv"], jst["conv"])


def test_bf16_policy_keeps_the_state_in_fp32():
    """Under the bf16 policy the output is bf16 and both state leaves stay
    fp32 (``new_conv`` is cast, as the reference's ``astype``); the
    output is within bf16 rounding of the f32 mixer's."""
    _, tp = _weights()
    pol = make_policy("bf16")
    bf = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    x = torch.from_numpy(_x((2, 16, CFG.d_model), 40))
    y, st = MB.apply_mamba(bf, x.to(torch.bfloat16), CFG, pol,
                           return_state=True)
    assert y.dtype == torch.bfloat16
    assert st["conv"].dtype == st["ssm"].dtype == torch.float32
    y32, _ = MB.apply_mamba(tp, x, CFG, POL, return_state=True)
    rel = float((y.float() - y32).norm() / y32.norm())
    assert rel < 5e-2, rel
