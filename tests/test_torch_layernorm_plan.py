"""The LayerNorm kernels' launch plans and wrapper arguments, on the CPU.

``kernels/layernorm.py`` sizes both grids from the row count alone: the
forward's rows a warp (``fwd_plan``) and the backward's row tiles
(``bwd_tiles``), each about one wave on the 132 SMs of an H100.  No device
property is read, so the backward's order of sums, and with it its bits,
cannot depend on the card.  These tests hold the plans at every path shape,
check what each wrapper hands the library for the five dtype codes (the
library replaced by a stand-in that records its arguments, the CUDA check
by a no-op), and check that every row width the wrappers took before is
still taken and every refusal still raises.  The kernels themselves run only
on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import types

import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels import layernorm as tln

# (rows, d) of the main paths: BERT-large phase 1 and 2, the MLM head at
# its predicted positions (phase 1 and 2), the rwkv raw prefill, a raw
# decode step and a continuous slot prefill
FWD_PATH = [(8192, 1024), (16384, 1024), (1280, 1024), (2560, 1024),
            (4096, 2048), (4, 2048), (256, 2048)]
BWD_PATH = FWD_PATH[:4]
# (x dtype, scale / bias dtype, the library's codes)
CODES = [(torch.float32, torch.float32, (0, 0)),
         (torch.bfloat16, torch.bfloat16, (1, 1)),
         (torch.bfloat16, torch.float32, (1, 0)),
         (torch.float16, torch.float16, (2, 2)),
         (torch.float16, torch.float32, (2, 0))]


@pytest.fixture
def no_device(monkeypatch):
    """Every device query raises: what passes under it reads none."""
    def refuse(*a, **k):
        raise AssertionError("a LayerNorm plan read a device property")
    for name in ("get_device_properties", "get_device_capability",
                 "device_count", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)


@pytest.fixture
def library(monkeypatch):
    """The library replaced by stand-ins that record their arguments, the
    CUDA check by a no-op and the stream by 0; returns the calls as
    ("fwd" | "bwd", args)."""
    calls = []
    monkeypatch.setattr(tln, "_fn", lambda: lambda *a: calls.append(
        ("fwd", a)) or 0)
    monkeypatch.setattr(tln, "_bwd_fn", lambda: lambda *a: calls.append(
        ("bwd", a)) or 0)
    monkeypatch.setattr(build, "check_cuda", lambda what, **t: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("rows,want", [
    (8192, (512, 4)),      # phase 1: 4 rows a warp, 512 blocks
    (16384, (512, 8)),     # phase 2
    (1280, (320, 1)),      # MLM head, phase 1
    (2560, (320, 2)),      # MLM head, phase 2
    (4096, (512, 2)),      # rwkv raw prefill
    (4, (1, 1)),           # rwkv raw decode: one block
    (256, (64, 1))])       # rwkv continuous slot prefill
def test_fwd_plan_at_the_path_shapes(no_device, rows, want):
    """The forward's (blocks, rows a warp): every row covered once by
    warps of equal shares, no block more than the rows need, the fewest
    rows a warp that fit one wave of FWD_WARPS_PER_SM warps an SM, and
    below a wave one row a warp (a small call launches as few blocks as
    the first port's one-row-a-warp kernel)."""
    blocks, rpw = tln.fwd_plan(rows)
    assert (blocks, rpw) == want
    per_block = tln.FWD_WARPS * rpw
    assert (blocks - 1) * per_block < rows <= blocks * per_block
    wave = tln.SMS * tln.FWD_WARPS_PER_SM
    assert -(-rows // rpw) <= wave
    assert rpw == 1 or -(-rows // (rpw - 1)) > wave
    if rows <= 256:
        assert blocks == -(-rows // tln.FWD_WARPS)


@pytest.mark.parametrize("rows", [r for r, _ in BWD_PATH] + [7, 1, 100000])
def test_bwd_tiles_fill_one_wave(no_device, rows):
    """The backward's tiles: whole warps of equal shares (a multiple of
    WARPS_BWD rows), every row in one tile, at most one wave of
    BWD_BLOCKS_PER_SM blocks an SM, with the fewest rows a warp that
    fit (so the fp32 partials stay at most one row a block of that
    wave)."""
    tiles, tile = tln.bwd_tiles(rows)
    rpw = tile // tln.WARPS_BWD
    assert tile % tln.WARPS_BWD == 0 and rpw >= 1
    assert (tiles - 1) * tile < rows <= tiles * tile
    wave = tln.SMS * tln.BWD_BLOCKS_PER_SM
    assert tiles <= wave
    assert rpw == 1 or -(-rows // (tln.WARPS_BWD * (rpw - 1))) > wave


@pytest.mark.parametrize("xdt,pdt,codes", CODES)
@pytest.mark.parametrize("rows,d", FWD_PATH)
def test_layernorm_passes_the_library_its_plan(no_device, library, xdt, pdt,
                                               codes, rows, d):
    """``layernorm`` hands the library the dtype codes, the vectors a lane
    (a power of two covering the row), the rows, the width, eps and the
    plan's rows a warp; outputs in x's dtype and float32 statistics; one
    launch counted."""
    ops.reset_launch_counts()
    x = torch.zeros((rows, d), dtype=xdt)
    y, mean, rstd = tln.layernorm(x, torch.ones(d, dtype=pdt),
                                  torch.zeros(d, dtype=pdt), eps=1e-5)
    (kind, a), = library
    lanes = d * x.element_size() // 16
    assert kind == "fwd"
    assert (a[0], a[1]) == codes
    assert a[2] >= 1 and a[2] & (a[2] - 1) == 0
    assert 32 * a[2] >= lanes > 16 * a[2]
    assert (a[9], a[10], a[12]) == (rows, d, tln.fwd_plan(rows)[1])
    assert a[11] == pytest.approx(1e-5)
    assert (y.shape, y.dtype) == (x.shape, xdt)
    assert mean.shape == rstd.shape == (rows,)
    assert mean.dtype == rstd.dtype == torch.float32
    assert ops.launch_counts()["layernorm"] == 1


@pytest.mark.parametrize("xdt,pdt,codes", CODES)
@pytest.mark.parametrize("rows,d", BWD_PATH + [(7, 512)])
def test_layernorm_bwd_passes_the_library_its_tiles(no_device, library, xdt,
                                                    pdt, codes, rows, d,
                                                    monkeypatch):
    """``layernorm_bwd`` hands the library the dtype codes, the vectors a
    lane, the rows, the width and the tile of ``bwd_tiles``, with a
    float32 partial buffer of one row of 2 d a tile; dx in x's dtype,
    dscale and dbias in scale's; one launch counted."""
    parts = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: parts.append(
        (a, k.get("dtype"))) or empty(*a, **k))
    ops.reset_launch_counts()
    x = torch.zeros((rows, d), dtype=xdt)
    stats = torch.zeros(rows)
    dx, dscale, dbias = tln.layernorm_bwd(x, x, torch.ones(d, dtype=pdt),
                                          stats, stats)
    (kind, a), = library
    tiles, tile = tln.bwd_tiles(rows)
    assert kind == "bwd"
    assert (a[0], a[1]) == codes
    assert 32 * a[2] >= d * x.element_size() // 16 > 16 * a[2]
    assert (a[-4], a[-3], a[-2]) == (rows, d, tile)
    assert ((tiles, 2 * d),) in [p[0] for p in parts
                                 if p[1] == torch.float32]
    assert (dx.shape, dx.dtype) == (x.shape, xdt)
    assert dscale.shape == dbias.shape == (d,)
    assert dscale.dtype == dbias.dtype == pdt
    assert ops.launch_counts()["layernorm_bwd"] == 1


def _widths(dtype, max_vectors):
    """Row widths around the vector size and the kernels' largest row."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    top = 32 * max_vectors * per
    return [per, 2 * per, 3 * per, 33 * per, top // 2 + per, top]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_every_width_taken_before_is_taken(no_device, library, dtype):
    """Both wrappers take every width the first port's kernels took: the
    forward rows of up to 32 vectors a lane (4096 f32, 8192 16-bit
    values), the backward rows of up to 8 (1024 and 2048), each a whole
    number of 16-byte vectors; ``nv`` is the smallest power of two whose
    32 lanes cover the row, as it was."""
    for d in _widths(dtype, 32):
        x = torch.zeros((3, d), dtype=dtype)
        tln.layernorm(x, torch.ones(d, dtype=dtype), torch.zeros(
            d, dtype=dtype))
        lanes, nv = d * x.element_size() // 16, library[-1][1][2]
        assert 32 * nv >= lanes and (nv == 1 or 16 * nv < lanes)
    for d in _widths(dtype, 8):
        x = torch.zeros((3, d), dtype=dtype)
        tln.layernorm_bwd(x, x, torch.ones(d, dtype=dtype), torch.zeros(3),
                          torch.zeros(3))
        lanes, nv = d * x.element_size() // 16, library[-1][1][2]
        assert 32 * nv >= lanes and (nv == 1 or 16 * nv < lanes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_the_backward_takes_rows_of_2048_values(no_device, library, dtype):
    """rwkv6-1.6b's LayerNorms (d_model 2048) train in every dtype: the
    backward takes rows of up to 2048 values, 16 vectors a lane in f32 (an
    instance of its own), 8 in 16 bits."""
    x = torch.zeros((3, 2048), dtype=dtype)
    tln.layernorm_bwd(x, x, torch.ones(2048, dtype=dtype), torch.zeros(3),
                      torch.zeros(3))
    assert library[-1][1][2] == {4: 16, 2: 8}[x.element_size()]


def _refusals(dtype):
    """(name, call, error, message) of every input the wrappers refuse."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    d = 8 * per
    x = torch.zeros((4, d), dtype=dtype)
    sc, st = torch.ones(d, dtype=dtype), torch.zeros(4)
    odd = torch.zeros((4, d + per // 2), dtype=dtype)
    other = torch.float16 if dtype != torch.float16 else torch.bfloat16
    off = torch.zeros(4 * d + 1, dtype=dtype)[1:].view(4, d)
    fwd, bwd = tln.layernorm, tln.layernorm_bwd
    wide_f = torch.zeros((1, 32 * 32 * per + per), dtype=dtype)
    wide_b = torch.zeros((1, 2048 + per), dtype=dtype)
    return [
        ("float64 x", lambda: fwd(x.double(), sc.double(), sc.double()),
         TypeError, "dtype"),
        ("params of another dtype", lambda: fwd(x, sc.to(other), sc),
         TypeError, "share x's dtype"),
        ("scale and bias apart", lambda: fwd(x, sc, sc.float())
         if dtype != torch.float32 else fwd(x, sc, sc.half()),
         TypeError, "share x's dtype"),
        ("ragged row", lambda: fwd(odd, torch.ones(odd.shape[-1], dtype=dtype),
                                   torch.ones(odd.shape[-1], dtype=dtype)),
         ValueError, "multiple"),
        ("misaligned x", lambda: fwd(off, sc, sc), ValueError, "aligned"),
        ("strided x", lambda: fwd(torch.zeros((d, 4), dtype=dtype).t(),
                                  sc, sc), ValueError, "contiguous"),
        ("short scale", lambda: fwd(x, sc[:-per], sc), ValueError, "shape"),
        ("forward row too wide", lambda: fwd(
            wide_f, torch.ones(wide_f.shape[-1], dtype=dtype),
            torch.ones(wide_f.shape[-1], dtype=dtype)), ValueError, "exceed"),
        ("backward row too wide", lambda: bwd(
            wide_b, wide_b, torch.ones(wide_b.shape[-1], dtype=dtype),
            torch.zeros(1), torch.zeros(1)), ValueError, "exceed"),
        ("dy of another dtype", lambda: bwd(x.to(other), x, sc, st, st),
         TypeError, "share a dtype"),
        ("dy of another shape", lambda: bwd(x[:2], x, sc, st, st),
         ValueError, "x's shape"),
        ("misaligned dy", lambda: bwd(off, x, sc, st, st), ValueError,
         "aligned"),
        ("short mean", lambda: bwd(x, x, sc, st[:3], st), ValueError,
         "mean"),
        ("float64 rstd", lambda: bwd(x, x, sc, st, st.double()), ValueError,
         "rstd"),
        ("CPU tensors, forward", lambda: fwd(x, sc, sc), ValueError, "CUDA"),
        ("CPU tensors, backward", lambda: bwd(x, x, sc, st, st), ValueError,
         "CUDA"),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", range(16))
def test_every_refusal_still_raises(dtype, case):
    """Each input the wrappers refused before still raises, before any
    build or launch (the CUDA check is left in place: CPU tensors that get
    past every other check are refused for their device)."""
    name, call, err, match = _refusals(dtype)[case]
    with pytest.raises(err, match=match):
        call()


def test_refusal_cases_are_all_listed():
    assert len(_refusals(torch.float32)) == 16


def test_device_busy_counts_overlapping_kernels_once():
    """The LayerNorm backward's column sum is a programmatic dependent
    launch: its span starts inside the main kernel's.  The profilers'
    device busy time (``profile_serve._busy_ms``) is the union of the
    CUDA events' spans, so the overlap counts once; host events are not
    counted."""
    from repro_torch.launch import profile_serve

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(start, end, device=cuda):
        return types.SimpleNamespace(device_type=device, time_range=types.
                                     SimpleNamespace(start=start, end=end))

    prof = types.SimpleNamespace(events=lambda: [
        ev(0, 10), ev(5, 20), ev(30, 40), ev(35, 36), ev(0, 100, cpu)])
    assert profile_serve._busy_ms(prof) == pytest.approx(0.030)
