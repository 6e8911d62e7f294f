"""The split design of the card's paged-decode kernel, on the CPU: the
wrapper's split plan, the plain per-split partials and their combine held
against the unsplit plain version and the JAX Pallas kernel (interpret
mode), and the arguments the wrapper hands the kernel.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the plain version there."""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import paged_attention as tpa
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

# (slot, KV head) pairs and SM counts the plan is asked about: the serve
# geometry (4 x 32 on an H100), one slot (path parity), a large batch, and
# a card with few SMs
PLAN_SHAPES = ((128, 132), (32, 132), (2048, 132), (4, 8))


@pytest.mark.parametrize("bh,n_sm", PLAN_SHAPES)
def test_split_plan_covers_every_live_page(bh, n_sm):
    """For tables of 1 to 70 pages of 16 tokens and every kv_len, each live
    page falls in exactly one split, the splits cover the table, and the
    splits the kernel counts live (ceil(pages / pps)) are those holding a
    live page, each at least one."""
    ps = 16
    for mp in range(1, 71):
        n_split, pps = tpa.split_plan(mp, bh, n_sm)
        assert 1 <= pps <= tpa.MAX_PAGES_PER_SPLIT
        assert n_split * pps >= mp > (n_split - 1) * pps
        lo = np.arange(n_split) * pps
        for kv_len in range(mp * ps + 1):
            n_pages = -(-kv_len // ps)
            hi = np.minimum(lo + pps, n_pages)
            owners = np.zeros(n_pages, int)
            for s in range(n_split):
                owners[lo[s]:hi[s]] += 1
            assert (owners == 1).all()
            n_live = -(-n_pages // pps)
            assert ((hi - lo) > 0).sum() == n_live
            assert (hi[:n_live] > lo[:n_live]).all()


def test_split_plan_splits_where_sms_would_idle():
    """One block an SM at most where the tables fit a block: 4 slots x 32
    KV heads on 132 SMs (the serve geometry) are not split, one slot's 32
    heads are split four ways (at least a page a warp), and a table past
    MAX_PAGES_PER_SPLIT is split whatever the batch."""
    assert tpa.split_plan(65, 128, 132) == (1, 65)
    assert tpa.split_plan(65, 32, 132) == (4, 17)
    assert tpa.split_plan(6, 20, 132) == (2, tpa.WARPS)
    assert tpa.split_plan(1, 128, 132) == (1, tpa.WARPS)
    n_split, pps = tpa.split_plan(300, 2048, 132)
    assert pps == tpa.MAX_PAGES_PER_SPLIT and n_split == 3


def _inputs(quantized, h=4):
    """4 slots over 7-page tables of 4 tokens: an empty slot, a tail page
    masked mid-page, a full table, and a slot whose table points at the
    trash page 0 only; GQA with ``h`` query heads over 2 KV heads (2 a KV
    head by default)."""
    rng = np.random.default_rng(7)
    b, kv, dh, ps, mp = 4, 2, 32, 4, 7
    pool = 1 + 3 * mp
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    if quantized:
        kp = rng.integers(-127, 128, (pool, ps, kv, dh)).astype(np.int8)
        vp = rng.integers(-127, 128, (pool, ps, kv, dh)).astype(np.int8)
        sc = dict(k_scale=rng.uniform(0.005, 0.02, (pool, kv)).astype(
                      np.float32),
                  v_scale=rng.uniform(0.005, 0.02, (pool, kv)).astype(
                      np.float32))
    else:
        kp = rng.normal(size=(pool, ps, kv, dh)).astype(np.float32)
        vp = rng.normal(size=(pool, ps, kv, dh)).astype(np.float32)
        sc = {}
    bt = np.zeros((b, mp), np.int32)
    bt[:3] = 1 + rng.permutation(3 * mp).reshape(3, mp)
    kvl = np.asarray([0, 13, mp * ps, 9], np.int32)
    return q, kp, vp, bt, kvl, sc


@functools.lru_cache(maxsize=None)
def _jax_out(quantized, softcap, h=4):
    q, kp, vp, bt, kvl, sc = _inputs(quantized, h)
    return np.asarray(jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(kvl), softcap=softcap, impl="pallas_interpret",
        **{k: jnp.asarray(v) for k, v in sc.items()}))


# (n_split, pages per split) over the 7-page tables: the plan at two
# geometries, one split, one page a split, and uneven runs
PLANS = (tpa.split_plan(7, 8, 132), tpa.split_plan(7, 8, 1), (1, 7),
         (7, 1), (3, 3))


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("quantized", [False, True])
def test_split_combine_matches_unsplit(quantized, softcap, plan):
    """Partials by split, added in split order, equal the unsplit plain
    version within 1e-6 (f32) and the Pallas kernel within 1e-5 (the
    tolerance of tests/test_torch_kernels.py); the empty slot gives exact
    zeros, and splits past a slot's last page hold nothing."""
    q, kp, vp, bt, kvl, sc = _inputs(quantized)
    t = {k: torch.from_numpy(v) for k, v in sc.items()}
    args = tuple(torch.from_numpy(x) for x in (q, kp, vp, bt, kvl))
    n_split, pps = plan
    m, l, acc = ref.paged_decode_partials_ref(
        *args, n_split=n_split, pages_per_split=pps, softcap=softcap, **t)
    got = ref.paged_combine_ref(m, l, acc)
    want = ref.paged_decode_attention_ref(*args, softcap=softcap, **t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _jax_out(quantized, softcap),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    for slot, length in enumerate(kvl):
        n_pages = -(-int(length) // 4)
        n_live = -(-n_pages // pps)
        assert (l[slot, :, :n_live] > 0).all()
        assert (l[slot, :, n_live:] == 0).all()
        assert torch.isinf(m[slot, :, n_live:]).all()


@pytest.mark.parametrize("plan", PLANS[1:])
@pytest.mark.parametrize("quantized", [False, True])
def test_split_combine_matches_unsplit_at_group_7(quantized, plan):
    """deepseek-coder-33b's group, 7 query heads a KV head (14 over 2):
    the per-split partials keep each query row of the group apart, and
    their combine equals the unsplit plain version within 1e-6 and the
    Pallas kernel within 1e-5, softcap 20."""
    q, kp, vp, bt, kvl, sc = _inputs(quantized, h=14)
    t = {k: torch.from_numpy(v) for k, v in sc.items()}
    args = tuple(torch.from_numpy(x) for x in (q, kp, vp, bt, kvl))
    n_split, pps = plan
    m, l, acc = ref.paged_decode_partials_ref(
        *args, n_split=n_split, pages_per_split=pps, softcap=20.0, **t)
    assert acc.shape == (4, 14, n_split, 32)
    got = ref.paged_combine_ref(m, l, acc)
    want = ref.paged_decode_attention_ref(*args, softcap=20.0, **t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _jax_out(quantized, 20.0, 14),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def test_split_plan_at_the_coder_serve_geometry():
    """The plan reads the (slot, KV head) pairs, not the group: the
    coder's 4 slots x 8 KV heads on 132 SMs split its 65-page serve tables
    four ways (32 blocks a split), as one slot's 32 heads of deepseek-7b
    are; one slot's 8 KV heads (path parity) 13 ways of 5 pages; and a
    300-page table is covered within one block's pages a split."""
    assert tpa.split_plan(65, 4 * 8, 132) == (4, 17)
    assert tpa.split_plan(65, 1 * 8, 132) == (13, 5)
    n_split, pps = tpa.split_plan(300, 4 * 8, 132)
    assert n_split * pps >= 300 and pps <= tpa.MAX_PAGES_PER_SPLIT


def test_combine_leaves_out_splits_without_tokens():
    """A split whose l is 0 does not enter the sum, whatever its m and acc
    hold; no live split at all gives zeros."""
    m = torch.tensor([[[0.5, 9.0, -1.0]]])
    l = torch.tensor([[[2.0, 0.0, 1.0]]])
    acc = torch.tensor([[[[4.0], [1e6], [3.0]]]])
    w = torch.exp(torch.tensor([0.0, -1.5]))
    want = (4.0 * w[0] + 3.0 * w[1]) / (2.0 * w[0] + 1.0 * w[1])
    got = ref.paged_combine_ref(m, l, acc)
    assert torch.allclose(got, want.reshape(1, 1, 1), rtol=1e-6)
    assert torch.equal(ref.paged_combine_ref(m, torch.zeros_like(l), acc),
                       torch.zeros((1, 1, 1)))


def _recording(monkeypatch):
    """The kernel library replaced by a stand-in that records its
    arguments, the device check by a no-op, 132 SMs; any read of a tensor
    back to the host raises."""
    calls = []
    monkeypatch.setattr(tpa, "_fn", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(build, "check_cuda", lambda what, **t: None)
    monkeypatch.setattr(tpa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))

    def no_readback(*a, **k):
        raise AssertionError("the paged-decode wrapper read a tensor back")
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, no_readback)
    return calls


@pytest.mark.parametrize("qdt,pdt,codes,kv,ps,plan", [
    (torch.bfloat16, torch.bfloat16, (1, 1), 8, 16, (4, 17)),
    (torch.bfloat16, torch.int8, (1, 2), 8, 16, (4, 17)),
    (torch.float32, torch.int8, (0, 2), 8, 16, (4, 17)),
    (torch.bfloat16, torch.bfloat16, (1, 1), 32, 16, (1, 65)),
    (torch.bfloat16, torch.int8, (1, 2), 8, 8, (4, 17)),
    (torch.bfloat16, torch.bfloat16, (1, 1), 32, 32, (1, 65)),
    (torch.bfloat16, torch.bfloat16, (1, 1), 8, 4, (0, 0)),
    (torch.bfloat16, torch.int8, (1, 2), 8, 24, (0, 0)),
    (torch.float32, torch.float32, (0, 0), 8, 16, (0, 0))])
def test_wrapper_passes_the_plan_without_reading_back(monkeypatch, qdt, pdt,
                                                      codes, kv, ps, plan):
    """16-bit and int8 pages of 8, 16 or 32 tokens go to the split kernel
    with the plan of the table width, the batch and the SM count (4 slots
    x 8 KV heads: four splits; x 32: none), and a workspace and the
    tickets where it splits; other page sizes and f32 pages go to the walk
    kernel (n_split 0).  Nothing is read back to the host, one launch is
    counted under its route, and a second call reuses the tickets without
    zeroing them again: the kernel leaves them at 0."""
    b, h, dh, mp, pool = 4, kv, 128, 65, 300
    q = torch.zeros((b, h, dh), dtype=qdt)
    pages = torch.zeros((pool, ps, kv, dh), dtype=pdt)
    sc = {}
    if pdt == torch.int8:
        sc = dict(k_scale=torch.ones((pool, kv)),
                  v_scale=torch.ones((pool, kv)))
    bt = torch.zeros((b, mp), dtype=torch.int32)
    kvl = torch.zeros((b,), dtype=torch.int32)
    calls = _recording(monkeypatch)
    tpa._tickets.cache_clear()
    zeros = []
    real_zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: zeros.append(
        (a, k.get("dtype"))) or real_zeros(*a, **k))
    ops.reset_launch_counts()
    n_split, pps = plan
    split = n_split > 1
    route = "walk" if n_split == 0 else "split"
    for call in range(2):
        out = tpa.paged_decode_attention(q, pages, pages, bt, kvl, **sc)
        assert (out.shape, out.dtype) == ((b, h, dh), qdt)
        a = calls[-1]
        assert a[:4] == (*codes, 1, dh)
        assert a[15:22] == (b, kv, pool, ps, mp, pps, n_split)
        assert (a[12] is not None, a[13] is not None) == (split, split)
        assert zeros == ([((b * kv,), torch.int32)] if split else [])
    assert calls[0][13] == calls[1][13]
    assert ops.launch_counts()["paged_decode"] == 2
    assert ops.launch_counts()[f"paged_decode_{route}"] == 2
    ops.reset_launch_counts()
    assert not any(k.startswith("paged_decode_")
                   for k in ops.launch_counts())


@pytest.mark.parametrize("pdt,codes", [(torch.bfloat16, (1, 1)),
                                       (torch.int8, (1, 2))])
def test_wrapper_passes_group_7(monkeypatch, pdt, codes):
    """deepseek-coder-33b at full width: 56 query heads over 8 KV heads go
    to the split kernel with G 7 and the serve geometry's plan (4 slots x
    8 KV heads: four splits of 17 pages), a workspace and the tickets."""
    b, h, kv, dh, mp, pool, ps = 4, 56, 8, 128, 65, 300, 16
    q = torch.zeros((b, h, dh), dtype=torch.bfloat16)
    pages = torch.zeros((pool, ps, kv, dh), dtype=pdt)
    sc = {}
    if pdt == torch.int8:
        sc = dict(k_scale=torch.ones((pool, kv)),
                  v_scale=torch.ones((pool, kv)))
    calls = _recording(monkeypatch)
    tpa._tickets.cache_clear()
    out = tpa.paged_decode_attention(
        q, pages, pages, torch.zeros((b, mp), dtype=torch.int32),
        torch.zeros((b,), dtype=torch.int32), **sc)
    assert (out.shape, out.dtype) == ((b, h, dh), torch.bfloat16)
    a = calls[-1]
    assert a[:4] == (*codes, 7, dh)
    assert a[15:22] == (b, kv, pool, ps, mp, 17, 4)
    assert a[12] is not None and a[13] is not None


@pytest.mark.parametrize("h,kv,dh,g,plan", [
    (24, 8, 64, 3, (4, 17)),     # granite-moe-3b-a800m
    (32, 4, 128, 8, (8, 9))])    # qwen3-moe-30b-a3b
@pytest.mark.parametrize("pdt,codes", [(torch.bfloat16, (1, 1)),
                                       (torch.int8, (1, 2))])
def test_wrapper_passes_the_moe_groups(monkeypatch, pdt, codes, h, kv, dh,
                                       g, plan):
    """The MoE decoders at full width: granite's 24 query heads over 8 KV
    heads at Dh 64 go to the split kernel with G 3 (4 slots x 8 KV heads:
    four splits of 17 pages), qwen3's 32 over 4 at Dh 128 with G 8 (4 x 4
    pairs: eight splits of 9 pages), with a workspace and the tickets, and
    each launch is counted under its group."""
    b, mp, pool, ps = 4, 65, 300, 16
    q = torch.zeros((b, h, dh), dtype=torch.bfloat16)
    pages = torch.zeros((pool, ps, kv, dh), dtype=pdt)
    sc = {}
    if pdt == torch.int8:
        sc = dict(k_scale=torch.ones((pool, kv)),
                  v_scale=torch.ones((pool, kv)))
    calls = _recording(monkeypatch)
    tpa._tickets.cache_clear()
    ops.reset_launch_counts()
    out = tpa.paged_decode_attention(
        q, pages, pages, torch.zeros((b, mp), dtype=torch.int32),
        torch.zeros((b,), dtype=torch.int32), **sc)
    assert (out.shape, out.dtype) == ((b, h, dh), torch.bfloat16)
    a = calls[-1]
    assert a[:4] == (*codes, g, dh)
    assert a[15:22] == (b, kv, pool, ps, mp, plan[1], plan[0])
    assert a[12] is not None and a[13] is not None
    assert ops.launch_counts()[f"paged_decode_g{g}"] == 1


def test_wrapper_sends_rows_16_byte_copies_cannot_read_to_the_walk(
        monkeypatch):
    """bf16 pages of 16 tokens whose rows start 8 bytes off a 16-byte
    boundary (vector-aligned for the walk kernel's 4-element loads) take
    the walk kernel instead of raising."""
    calls = _recording(monkeypatch)
    q = torch.zeros((2, 4, 128), dtype=torch.bfloat16)
    pages = torch.zeros((9, 16, 4, 132), dtype=torch.bfloat16)[..., 4:]
    bt = torch.zeros((2, 4), dtype=torch.int32)
    kvl = torch.zeros((2,), dtype=torch.int32)
    tpa.paged_decode_attention(q, pages, pages, bt, kvl)
    assert calls[-1][20:22] == (0, 0)


@pytest.mark.parametrize("case", ["misaligned_rows", "head_dim", "group"])
def test_wrapper_refuses_what_the_split_kernel_cannot_read(monkeypatch,
                                                           case):
    """Page rows that neither kernel's loads can read, head dims other than
    64/128 and H/KV outside 1, 2, 3, 4, 7, 8 (here 5) raise before any
    launch."""
    calls = _recording(monkeypatch)
    h, dh, pad = {"misaligned_rows": (4, 128, 1), "head_dim": (4, 96, 0),
                  "group": (20, 128, 0)}[case]
    q = torch.zeros((2, h, dh), dtype=torch.bfloat16)
    pages = torch.zeros((9, 16, 4, dh + pad), dtype=torch.bfloat16)
    pages = pages[..., pad:]
    bt = torch.zeros((2, 4), dtype=torch.int32)
    kvl = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match={"misaligned_rows": "aligned",
                                          "head_dim": "Dh",
                                          "group": "H/KV"}[case]):
        tpa.paged_decode_attention(q, pages, pages, bt, kvl)
    assert not calls
