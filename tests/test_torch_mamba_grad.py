"""The selective scan's backward (``repro_torch/models/mamba.py``
``_SelectiveScan``) against the JAX package: ``jax.vjp`` of the
reference's ``apply_mamba`` (``jax.grad`` through its chunked associative
scan) against the port's autograd, on tests/test_torch_mamba.py's mixer
(jamba's smoke variant at d_model 64: d_inner 128, N 16) and weights, by
chunks of 8 over S 32 (4 chunks) from a drawn state, so the reverse
recurrence crosses three chunk edges and reaches h0; the gradients of all
9 leaves, the input and both state rows within that file's TOL (rtol
1e-4, atol 1e-5).  Then the Function alone against autograd through the
port's plain chunked scan (``_scan_blocks``: the doubling scan's own
graph) and sequential scan (``_ssm_sequential``), with nonzero h0 and a
cotangent on h_final; the same bits from two backward passes; the
forward's bits equal to the no-grad (serving) path's; and what the
Function keeps for its backward: no (B, S, din, N) tensor.

The reference's mixer is jitted (eager JAX compiles each operation on
its first call)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as JMB
from repro_torch.models import mamba as MB
from test_torch_mamba import CFG, JCFG, JPOL, POL, TOL, _weights, _x
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

B, S, CHUNK = 2, 32, 8
LEAVES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
          "a_log", "d_skip", "out_proj")


def _state(seed=50):
    """A drawn decode state: conv rows O(0.5), ssm rows O(0.1)."""
    rng = np.random.default_rng(seed)
    din, n, dc = CFG.mamba_d_inner, CFG.mamba_d_state, CFG.mamba_d_conv
    return {"conv": (0.5 * rng.standard_normal((B, dc - 1, din))).astype(
                np.float32),
            "ssm": (0.1 * rng.standard_normal((B, din, n))).astype(
                np.float32)}


@functools.lru_cache(maxsize=None)
def _reference_vjp():
    """(inputs, cotangents, the reference's gradients) of ``apply_mamba``
    over (B, S, d) from ``_state``, by chunks of CHUNK, its output and
    final state both given cotangents: gradients of the 9 leaves, x and
    the state rows."""
    jp, _ = _weights()
    x, st = _x((B, S, CFG.d_model), 51), _state()

    def f(p, x, conv, ssm):
        y, new = JMB.apply_mamba(p, x, JCFG, JPOL,
                                 state={"conv": conv, "ssm": ssm},
                                 return_state=True, chunk=CHUNK)
        return y, new["ssm"]

    args = (jp, jnp.asarray(x), jnp.asarray(st["conv"]),
            jnp.asarray(st["ssm"]))
    (y, h), vjp = jax.vjp(jax.jit(f), *args)
    rng = np.random.default_rng(52)
    cots = [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in (y, h)]
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    return x, st, cots, grads


def test_vjp_matches_the_reference_over_four_chunks_from_a_state():
    """Every leaf's, the input's and the state rows' gradients through
    the port's mixer (the chunked path, which under grad is
    ``_SelectiveScan``) against ``jax.vjp`` of the reference's, within
    TOL; the forward too."""
    _, tp = _weights()
    x, st, cots, (jg, jx, jconv, jssm) = _reference_vjp()
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    state = {k: torch.from_numpy(v).requires_grad_() for k, v in st.items()}
    y, new = MB.apply_mamba(params, xt, CFG, POL, state=state,
                            return_state=True, chunk=CHUNK)
    assert y.grad_fn is not None and "_SelectiveScan" in repr(
        new["ssm"].grad_fn)
    got = torch.autograd.grad(
        (y, new["ssm"]), [params[k] for k in LEAVES] + [xt, state["conv"],
                                                      state["ssm"]],
        [torch.from_numpy(c) for c in cots])
    want = [jg[k] for k in LEAVES] + [jx, jconv, jssm]
    for name, g, w in zip(LEAVES + ("x", "conv", "ssm"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def _scan_inputs(seed=60, b=B, s=S):
    """dt after softplus, x1, B, C, A = -exp(a_log) and a nonzero h0, fp32
    leaves requiring grad, at a mixer's scales (dt in [1e-3, 0.5])."""
    rng = np.random.default_rng(seed)
    din, n = CFG.mamba_d_inner, CFG.mamba_d_state
    arr = lambda *shape, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32))
    dt = torch.nn.functional.softplus(arr(b, s, din) - 2.0)
    a = -torch.exp(torch.log(torch.arange(1, n + 1, dtype=torch.float32))
                   .expand(din, n) + arr(din, n, scale=0.1))
    ins = (dt, arr(b, s, din), arr(b, s, n), arr(b, s, n), a,
           arr(b, din, n, scale=0.1))
    return [t.clone().requires_grad_() for t in ins]


def _plain(dt, x1, b_in, c_in, a, h0, sequential):
    """The scan without the Function: autograd through the chunked doubling
    scan, or through the step-by-step one."""
    if not sequential:
        return MB._scan_blocks(dt, dt * x1, b_in, c_in, a, h0, CHUNK)
    a_coef = torch.exp(dt[..., None] * a)
    bx = (dt * x1)[..., None] * b_in[:, :, None, :]
    hs, h = MB._ssm_sequential(a_coef, bx, h0)
    return torch.einsum("bsdn,bsn->bsd", hs, c_in), h


def _cotangents(seed=61):
    rng = np.random.default_rng(seed)
    din, n = CFG.mamba_d_inner, CFG.mamba_d_state
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((B, S, din), (B, din, n))]


@pytest.mark.parametrize("sequential", [False, True])
def test_function_matches_autograd_through_the_plain_scans(sequential):
    """The Function's outputs and the gradients of dt, x1, B, C, A and h0
    against autograd through the plain chunked and sequential scans, the
    output and h_final both given cotangents, within TOL (relative to
    each gradient's largest element for the absolute part)."""
    ins = _scan_inputs()
    cots = _cotangents()
    got_out = MB._SelectiveScan.apply(*ins, CHUNK)
    got = torch.autograd.grad(got_out, ins, cots)
    want_out = _plain(*ins, sequential)
    want = torch.autograd.grad(want_out, ins, cots)
    for g, w in zip(got_out, want_out):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   **TOL)
    for name, g, w in zip(("dt", "x1", "B", "C", "A", "h0"), got, want):
        w = w.numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=TOL["rtol"],
            atol=TOL["atol"] * max(1.0, float(np.abs(w).max())),
            err_msg=name)


def test_two_backward_passes_give_the_same_bits():
    """The backward is elementwise work and fixed-order reductions: two
    passes over the same graph's inputs give every gradient in the same
    bits."""
    ins = _scan_inputs(62)
    cots = _cotangents(63)
    first, second = (torch.autograd.grad(MB._SelectiveScan.apply(
        *ins, CHUNK), ins, cots) for _ in range(2))
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)


def test_forward_keeps_the_serving_bits_and_only_chunk_starts():
    """Under grad the mixer's output and state are the no-grad (serving)
    path's bits; the Function saves its inputs and one state a chunk,
    (B, S / chunk, din, N), and no tensor of (B, S, din, N) elements."""
    _, tp = _weights()
    x = torch.from_numpy(_x((B, S, CFG.d_model), 64))
    st = {k: torch.from_numpy(v) for k, v in _state(65).items()}
    with torch.no_grad():
        y0, s0 = MB.apply_mamba(tp, x, CFG, POL, state=st,
                                return_state=True, chunk=CHUNK)
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y1, s1 = MB.apply_mamba(params, x, CFG, POL, state=st,
                            return_state=True, chunk=CHUNK)
    assert torch.equal(y0, y1.detach())
    assert torch.equal(s0["ssm"], s1["ssm"].detach())
    node = s1["ssm"].grad_fn
    assert type(node).__name__ == "_SelectiveScanBackward"
    din, n = CFG.mamba_d_inner, CFG.mamba_d_state
    shapes = [tuple(t.shape) for t in node.saved_tensors]
    assert (B, S // CHUNK, din, n) in shapes
    assert max(int(np.prod(s)) for s in shapes) < B * S * din * n


def test_a_ragged_sequence_still_raises_under_grad():
    """S 24 in chunks of 16 raises under grad too, as the reference
    asserts."""
    params = {k: v.clone().requires_grad_() for k, v in _weights()[1].items()}
    with pytest.raises(ValueError, match="multiple of the chunk"):
        MB.apply_mamba(params, torch.zeros((1, 24, CFG.d_model)), CFG, POL,
                       chunk=16)
