"""The wkv6 kernel's grid plan and wrapper arguments, on the CPU.

``kernels/wkv6.py`` ``plan`` picks one or two blocks a (b, h) head from the
shapes alone, so no device property is read and the kernel's order of sums,
and with it its bits, cannot depend on the card.  These tests hold the plan
at the path shapes, check what the wrapper hands the library (the library
replaced by a stand-in that records its arguments, the CUDA check by a
no-op): dtype code, strides, chunk, grid and the 16-byte alignment flag
that picks ``cp.async``, and check that every refusal still raises.  The
kernel itself runs only on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import types

import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels import wkv6 as twkv


@pytest.fixture
def no_device(monkeypatch):
    """Every device query raises: what passes under it reads none."""
    def refuse(*a, **k):
        raise AssertionError("the wkv6 plan read a device property")
    for name in ("get_device_properties", "get_device_capability",
                 "device_count", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)


@pytest.fixture
def library(monkeypatch):
    """The library replaced by a stand-in that records its arguments, the
    CUDA check by a no-op and the stream by 0."""
    calls = []

    def fake(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(twkv, "_fn", lambda: fake)
    monkeypatch.setattr(build, "check_cuda", lambda what, **t: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("b,h,want", [
    (4, 32, 1),     # the raw prefill's batch 4: 128 heads, one block each
    (1, 32, 2),     # batch 1: 32 heads, each split over two blocks
    (2, 32, 2),     # 64 heads: 128 blocks still fit 132 SMs
    (3, 32, 1),     # 96 heads: 192 blocks would not
    (2, 2, 2),      # the CPU tests' small shapes
    (64, 32, 1)])
def test_plan_at_the_path_shapes(no_device, b, h, want):
    """Two blocks a head (each owning 32 of the state's 64 value columns)
    exactly where 2 B H blocks fit one block an SM of an H100."""
    assert twkv.plan(b, h) == want
    assert (want == 2) == (2 * b * h <= twkv.N_SM)


def _args(b, s, h, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(b, s, h, 64, generator=g).to(dtype)
               for _ in range(3))
    logw = -torch.rand(b, s, h, 64, generator=g)
    return r, k, v, logw, torch.randn(h, 64).to(dtype), \
        torch.zeros(b, h, 64, 64)


def _check_call(call, args, dtype_code, s, chunk, nsplit, aligned):
    r, k, v, logw, u, s0 = args
    b, _, h, _ = r.shape
    (code, rp, kp, vp, wp, up, s0p, op, sfp, strides, B, H, S, L, n, al,
     stream) = call
    assert code == dtype_code
    assert (rp, kp, vp, wp, up, s0p) == tuple(
        t.data_ptr() for t in (r, k, v, logw, u, s0))
    assert op != sfp and None not in (op, sfp)
    assert list(strides) == [t.stride(ax) for ax in (0, 1, 2)
                             for t in (r, k, v, logw)]
    assert (B, H, S, L, n, al, stream) == (b, h, s, chunk, nsplit,
                                            aligned, 0)


@pytest.mark.parametrize("b,s,h,chunk,want_chunk", [
    (4, 1024, 32, 64, 64),    # the raw prefill
    (1, 1024, 32, 64, 64),
    (2, 128, 2, 32, 32),
    (2, 6, 2, 64, 6),         # one short chunk: a short last sub-chunk
    (2, 120, 2, 60, 60)])
def test_wrapper_arguments(no_device, library, b, s, h, chunk, want_chunk):
    """Contiguous bf16 inputs: dtype code 1, the (B, S, H) strides of r,
    k, v, logw, chunk = min(chunk, S), the plan's grid, 16-byte aligned;
    one launch counted; outputs float32 of the reference's shapes."""
    args = _args(b, s, h)
    ops.reset_launch_counts()
    o, sf = twkv.wkv6(*args, chunk=chunk)
    assert len(library) == 1 and ops.launch_counts()["wkv6"] == 1
    assert o.shape == (b, s, h, 64) and sf.shape == (b, h, 64, 64)
    assert o.dtype == sf.dtype == torch.float32
    _check_call(library[0], args, 1, s, want_chunk, twkv.plan(b, h), 1)


def test_wrapper_strided_and_unaligned(no_device, library, monkeypatch):
    """f32 views of a wider activation keep their strides and stay 16-byte
    aligned; views one element off the 16-byte grid (r, k, v offset by a
    float) are passed as unaligned, so the kernel takes plain loads; the
    grid the plan returns reaches the library."""
    wide = torch.randn(2, 128, 3, 2, 64)
    _, _, _, logw, u, s0 = _args(2, 128, 2, torch.float32)
    args = (wide[:, :, 0], wide[:, :, 1], wide[:, :, 2], logw, u, s0)
    with monkeypatch.context() as m:
        m.setattr(twkv, "plan", lambda b, h: 1)
        twkv.wkv6(*args)
    _check_call(library[-1], args, 0, 128, 64, 1, 1)
    odd = torch.randn(2, 128, 2, 65)[..., 1:]
    args = (odd, odd, odd, logw, u, s0)
    twkv.wkv6(*args)
    _check_call(library[-1], args, 0, 128, 64, twkv.plan(2, 2), 0)


def test_wrapper_refusals(library):
    """Every input the kernel does not take raises before a launch: f16
    (no serving path is f16), CPU tensors, mixed dtypes, logw or s0 not
    float32, shapes, a strided last dim, non-contiguous u or s0, a length
    that is no multiple of the chunk, an empty sequence."""
    args = list(_args(2, 64, 2))
    half = [a.half() for a in args[:3]] + args[3:]
    with pytest.raises(TypeError, match="no serving path is f16"):
        twkv.wkv6(*half)
    bad = {
        "k float32": (1, args[1].float(), TypeError),
        "logw bf16": (3, args[3].bfloat16(), TypeError),
        "s0 bf16": (5, args[5].bfloat16(), TypeError),
        "head size 32": (0, args[0][..., :32], ValueError),
        "strided last dim": (2, torch.randn(2, 64, 2, 128).bfloat16()[..., ::2],
                             ValueError),
        "u transposed": (4, args[4].t().contiguous().t(), ValueError),
        "s0 transposed": (5, args[5].transpose(-1, -2), ValueError),
    }
    for name, (i, t, err) in bad.items():
        call = list(args)
        call[i] = t
        with pytest.raises(err):
            twkv.wkv6(*call)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        twkv.wkv6(*_args(2, 100, 2))
    with pytest.raises(ValueError, match="empty"):
        twkv.wkv6(*_args(2, 0, 2))
    assert library == []


def test_wrapper_refuses_cpu_tensors():
    """Without the stand-ins a CPU tensor is refused before the library is
    loaded: the wrapper launches its kernel or raises, and never falls back
    to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        twkv.wkv6(*_args(2, 64, 2))


def test_chip_smoke_bound_counts_the_subchunk_form():
    """``chip_smoke.wkv6_bound`` at the raw prefill's (4, 1024, 32, 64)
    bf16: 121.6 MB (0.0363 ms at 3.35 TB/s, so bytes bound it), ~99 M
    exponentials, ~3.2 GFLOP of useful products run as ~7.9 G TF32 flops;
    the first port's count (4.106 G operations, 0.0613 ms) kept beside it."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as smoke
    r = torch.zeros(4, 1024, 32, 64, dtype=torch.bfloat16)
    u = torch.zeros(32, 64, dtype=torch.bfloat16)
    ms, by, work = smoke.wkv6_bound(r, u, 64)
    assert by == "bytes" and ms == pytest.approx(0.0363, abs=5e-5)
    assert work["bytes"] == 121638912
    assert work["exps"] == 2048 * (4 * 120 * 64 + 48 * 64 + 96 * 64
                                   + 2 * 64 * 64 + 64)
    assert work["tf32_flops"] == pytest.approx(7.919e9, rel=1e-3)
    assert work["old_ops"] == pytest.approx(4.106e9, rel=1e-3)
    assert work["old_ms"] == pytest.approx(0.0613, abs=5e-5)
