"""The port's plain RWKV-6 recurrence (``kernels/ref.py`` ``wkv6_ref``, the
CPU side of ``kernels.ops.wkv6``) against the JAX Pallas kernel in
interpret mode and the reference's sequential oracle, and the dispatch and
checks of the CUDA kernel's wrapper.  The kernel itself runs only on the
card: ``chip_smoke.py`` holds it against ``wkv6_ref`` there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.wkv6 import wkv6 as jwkv6
from repro.models import rwkv as JRW
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as twkv
from repro_torch.models import rwkv as RW

# the reference test's tolerance (tests/test_kernels.py:161-162)
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(s, b=2, h=2, hs=64, seed=0):
    """The distribution of tests/test_kernels.py:144-151, drawn with numpy:
    r, k, v ~ N(0, 1), logw = -exp(N(0, 1) - 2), u = 0.5 N, s0 = 0.1 N."""
    rng = np.random.default_rng(seed + s)
    r, k, v = (rng.standard_normal((b, s, h, hs)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, hs)) - 2.0).astype(
        np.float32)
    u = (0.5 * rng.standard_normal((h, hs))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((b, h, hs, hs))).astype(np.float32)
    return r, k, v, logw, u, s0


def _t(args):
    return [torch.from_numpy(a) for a in args]


def _j(args):
    return [jnp.asarray(a) for a in args]


@pytest.mark.parametrize("s,chunk", [(128, 32), (256, 64), (64, 64),
                                     (32, 64)])
def test_wkv6_ref_matches_pallas_kernel_and_sequential(s, chunk):
    """``wkv6_ref`` and ``ops.wkv6`` on CPU tensors against the Pallas
    kernel (interpret mode) and the reference's sequential recurrence;
    s = 32 < chunk runs one chunk of 32."""
    args = _inputs(s)
    o_pal, sf_pal = jwkv6(*_j(args), chunk=chunk, interpret=True)
    o_seq, sf_seq = JRW.wkv6_sequential(*_j(args))
    o, sf = ref.wkv6_ref(*_t(args), chunk=chunk)
    assert o.dtype == sf.dtype == torch.float32
    assert o.shape == (2, s, 2, 64) and sf.shape == (2, 2, 64, 64)
    for want_o, want_sf in ((o_pal, sf_pal), (o_seq, sf_seq)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(sf.numpy(), np.asarray(want_sf), **TOL)
    o2, sf2 = ops.wkv6(*_t(args), chunk=chunk)
    assert torch.equal(o2, o) and torch.equal(sf2, sf)


def test_wkv6_ref_bf16_inputs_compute_in_f32():
    """bf16 r, k, v (the full-width compute dtype) and a bf16 u: the plain
    version upcasts and returns f32, equal to the f32 run on the rounded
    values."""
    r, k, v, logw, u, s0 = _t(_inputs(128))
    bf = [t.to(torch.bfloat16) for t in (r, k, v, u)]
    o, sf = ref.wkv6_ref(bf[0], bf[1], bf[2], logw, bf[3], s0)
    o32, sf32 = ref.wkv6_ref(*(t.float() for t in bf[:3]), logw,
                             bf[3].float(), s0)
    assert o.dtype == torch.float32
    assert torch.equal(o, o32) and torch.equal(sf, sf32)


def test_wkv6_sequential_matches_jax():
    """The port's step-by-step recurrence (decode and masked prefill)
    against the reference's."""
    args = _inputs(40)
    want_o, want_sf = JRW.wkv6_sequential(*_j(args))
    o, sf = RW.wkv6_sequential(*_t(args))
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(want_sf), **TOL)


def test_wkv6_strong_decay_stays_finite():
    """logw = -50 everywhere (tests/test_kernels.py:166): every exponent
    of the ordered-difference form is <= 0, so nothing overflows; the
    Pallas kernel agrees."""
    b, s, h, hs = 1, 64, 1, 64
    one = np.ones((b, s, h, hs), np.float32)
    args = (one, one, one, np.full((b, s, h, hs), -50.0, np.float32),
            np.zeros((h, hs), np.float32), np.zeros((b, h, hs, hs),
                                                    np.float32))
    o, sf = ref.wkv6_ref(*_t(args), chunk=16)
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    want_o, want_sf = jwkv6(*_j(args), chunk=16, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(want_sf), **TOL)


def test_wkv6_length_not_a_multiple_of_the_chunk_raises():
    """S = 100 with chunk 64: the port raises ValueError naming the
    constraint; the reference's jnp path asserts there."""
    args = _inputs(100)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ref.wkv6_ref(*_t(args))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.wkv6(*_t(args))
    with pytest.raises(AssertionError):
        jops.wkv6(*_j(args), impl="jnp")


def test_wkv6_dispatch_and_wrapper_checks():
    """CPU tensors take the plain version and launch nothing; an unknown
    impl is refused; the CUDA wrapper raises on CPU tensors and float16
    before it builds or launches anything."""
    args = _t(_inputs(64))
    ops.reset_launch_counts()
    ops.wkv6(*args)
    assert ops.launch_counts()["wkv6"] == 0
    with pytest.raises(ValueError, match="impl"):
        ops.wkv6(*args, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        twkv.wkv6(*args)
    half = [a.to(torch.float16) for a in args[:3]] + args[3:]
    with pytest.raises(TypeError, match="float16"):
        twkv.wkv6(*half)


# (s, chunk): the cases above, plus chunks of 6 and 60 rows (the card
# kernel's last sub-chunk of 16 rows is short) over one and two chunks
SUBCHUNK_CASES = [(128, 32), (256, 64), (64, 64), (32, 64), (6, 64),
                  (60, 64), (120, 60)]


@pytest.mark.parametrize("s,chunk", SUBCHUNK_CASES)
def test_wkv6_subchunk_form_matches_pallas_kernel_and_sequential(s, chunk):
    """The card kernel's sub-chunk factorisation, mirrored in plain
    PyTorch (``ref.wkv6_subchunk_ref``), exact and with its products
    rounded as the kernel's 3xTF32 split rounds them, against the Pallas
    kernel (interpret mode) and the reference's sequential recurrence."""
    args = _inputs(s)
    o_pal, sf_pal = jwkv6(*_j(args), chunk=chunk, interpret=True)
    o_seq, sf_seq = JRW.wkv6_sequential(*_j(args))
    for rounding in (None, "3x"):
        o, sf = ref.wkv6_subchunk_ref(*_t(args), chunk=chunk,
                                      rounding=rounding)
        assert o.shape == (2, s, 2, 64) and sf.shape == (2, 2, 64, 64)
        for want_o, want_sf in ((o_pal, sf_pal), (o_seq, sf_seq)):
            np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
            np.testing.assert_allclose(sf.numpy(), np.asarray(want_sf),
                                       **TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv6_subchunk_form_strong_decay_stays_finite(chunk):
    """logw = -50 everywhere (tests/test_kernels.py:166) in chunks of 16
    and 64: every factor of the sub-chunk form has an exponent <= 0, so the
    off-diagonal factors underflow to 0 and nothing overflows; equal to the
    Pallas kernel."""
    b, s, h, hs = 1, 128, 1, 64
    one = np.ones((b, s, h, hs), np.float32)
    args = (one, one, one, np.full((b, s, h, hs), -50.0, np.float32),
            np.zeros((h, hs), np.float32), np.zeros((b, h, hs, hs),
                                                    np.float32))
    want_o, want_sf = jwkv6(*_j(args), chunk=chunk, interpret=True)
    for rounding in (None, "3x"):
        o, sf = ref.wkv6_subchunk_ref(*_t(args), chunk=chunk,
                                      rounding=rounding)
        assert torch.isfinite(o).all() and torch.isfinite(sf).all()
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(sf.numpy(), np.asarray(want_sf), **TOL)


def test_wkv6_tolerance_needs_the_3xtf32_split():
    """Why the card kernel splits each tensor-core operand in two: with its
    products' operands cut to TF32 once, the sub-chunk form misses the
    reference tolerance (rtol = atol = 1e-4, and 1e-4 relative L2); with
    the 3xTF32 split it holds it."""
    args = _t(_inputs(256))
    o, sf = ref.wkv6_ref(*args, chunk=64)
    o3, sf3 = ref.wkv6_subchunk_ref(*args, chunk=64, rounding="3x")
    np.testing.assert_allclose(o3.numpy(), o.numpy(), **TOL)
    np.testing.assert_allclose(sf3.numpy(), sf.numpy(), **TOL)
    assert float((o3 - o).norm() / o.norm()) < 1e-5
    o1, sf1 = ref.wkv6_subchunk_ref(*args, chunk=64, rounding="1x")
    assert not np.allclose(o1.numpy(), o.numpy(), **TOL)
    assert float((o1 - o).norm() / o.norm()) > 1e-4


def test_tf32_cut_and_split():
    """``ref.tf32`` keeps the sign, exponent and top 10 mantissa bits;
    big + small recovers x to 2**-21 of |x| once small is cut too."""
    x = torch.tensor([1.0 + 2.0 ** -10 + 2.0 ** -11, -3.0 - 2.0 ** -12,
                      1e-30, 0.0])
    assert ref.tf32(x).tolist() == [1.0 + 2.0 ** -10, -3.0, float(
        ref.tf32(torch.tensor([1e-30]))), 0.0]
    y = torch.randn(4096)
    big = ref.tf32(y)
    small = ref.tf32(y - big)
    assert ((y - big).abs() <= 2.0 ** -10 * y.abs()).all()
    assert ((y - big - small).abs() <= 2.0 ** -20 * y.abs()).all()
