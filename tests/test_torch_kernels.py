"""The port's kernel plain versions against the JAX Pallas kernels (run in
interpret mode on the CPU), and the device dispatch of the kernel wrappers.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there."""
import importlib.util
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import naive_attention as jnaive
from repro_torch.kernels import bias_gelu as tbg
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import lamb_update as tlu
from repro_torch.kernels import layernorm as tln
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import wkv6 as twkv
from repro_torch.launch import mutation_check


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (48, 0.0), (0, 30.0),
                                            (48, 30.0)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_pallas_kernel(causal, window, softcap, kv):
    """out and lse at f32, rtol/atol 2e-4 (tests/test_kernels.py:58).  The
    Pallas kernel takes equal head counts, so it gets K/V expanded across
    the GQA group; the port reads KV head h // (H / KV) by index."""
    rng = np.random.default_rng(0)
    b, h, s, dh = 1, 4, 128, 32
    q = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, dh)).astype(np.float32)
    rep = h // kv
    want, want_lse = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=1)),
        jnp.asarray(np.repeat(v, rep, axis=1)), causal=causal, window=window,
        softcap=softcap, block_q=64, block_k=64, interpret=True,
        return_lse=True)
    got, got_lse = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                       window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=2e-4, atol=2e-4)


def test_flash_ref_keeps_dtype():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 32))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    out, lse = ref.flash_attention_ref(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert out.shape == q.shape and lse.shape == (1, 2, 64)


def _paged_inputs(quantized):
    """The inputs of tests/test_paged.py::test_paged_kernel_matches_ref:
    disjoint tables, unallocated entries on the trash page, a kv_len 0
    slot, GQA with 2 query heads per KV head."""
    rng = np.random.default_rng(0)
    b, h, kv, dh, pool, ps = 3, 4, 2, 32, 9, 4
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
    bt = np.asarray([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 0]], np.int32)
    kvl = np.asarray([6, 11, 0], np.int32)
    return q, kp, vp, bt, kvl, sc


@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_ref_matches_pallas_kernel(quantized, softcap):
    """f32 and int8 pages at 1e-5 (tests/test_paged.py:49); the empty slot
    gives zeros, not NaN."""
    q, kp, vp, bt, kvl, sc = _paged_inputs(quantized)
    want = jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(kvl), softcap=softcap, impl="pallas_interpret",
        **{k: jnp.asarray(v) for k, v in sc.items()})
    got = ops.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(bt), _t(kvl), softcap=softcap,
        **{k: _t(v) for k, v in sc.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got[2].numpy() == 0.0)


def test_paged_ref_clamps_page_ids():
    """Out-of-range table entries read page P-1, as the kernel's clamp."""
    q, kp, vp, bt, kvl, _ = _paged_inputs(False)
    wild = bt.copy()
    wild[0, 1] = 1000
    clamped = bt.copy()
    clamped[0, 1] = kp.shape[0] - 1
    a = ref.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(wild),
                                       _t(kvl))
    b = ref.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(clamped),
                                       _t(kvl))
    assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor goes to the plain version and leaves the launch
    counters at 0; the result is the plain version's, bit for bit."""
    rng = np.random.default_rng(2)
    ops.reset_launch_counts()
    q, k, v = (_t(rng.standard_normal((1, 2, 128, 32)).astype(np.float32))
               for _ in range(3))
    out, lse = ops.flash_attention(q, k, v, causal=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, causal=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    pq, kp, vp, bt, kvl, _ = _paged_inputs(False)
    got = ops.paged_decode_attention(_t(pq), _t(kp), _t(vp), _t(bt),
                                     _t(kvl))
    assert torch.equal(got, ref.paged_decode_attention_ref(
        _t(pq), _t(kp), _t(vp), _t(bt), _t(kvl)))
    x = _t(rng.standard_normal((6, 64)).astype(np.float32))
    sc, bi = torch.ones(64), torch.zeros(64)
    y = ops.layernorm(x, sc, bi)
    assert torch.equal(y, ref.layernorm_ref(x, sc, bi)[0])
    assert torch.equal(ops.bias_gelu(x, bi), ref.bias_gelu_ref(x, bi))
    m2, v2, upd = ops.lamb_moments(x, x, x, x.abs(), step=3)
    assert torch.equal(upd, ref.lamb_moments_ref(x, x, x, x.abs(),
                                                 step=3)[2])
    _, mean, rstd = ref.layernorm_ref(x, sc, bi)
    for g, w in zip(ops.layernorm_bwd(x, x, sc, mean, rstd),
                    ref.layernorm_bwd_ref(x, x, sc, mean, rstd)):
        assert torch.equal(g, w)
    for g, w in zip(ops.bias_gelu_bwd(x, x, bi),
                    ref.bias_gelu_bwd_ref(x, x, bi)):
        assert torch.equal(g, w)
    qg = q.clone().requires_grad_()
    ops.flash_attention_vjp(qg, k, v, causal=True).sum().backward()
    assert ops.launch_counts() == {
        "flash_fwd": 0, "flash_bwd_prep": 0, "flash_bwd": 0,
        "flash_bwd_post": 0, "paged_decode": 0, "layernorm": 0,
        "layernorm_bwd": 0, "bias_gelu": 0, "bias_gelu_bwd": 0,
        "lamb_moments": 0, "wkv6": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers raise on a CPU tensor before any build or launch:
    a plain version is reached only by dispatch, never by fallback."""
    x = torch.zeros((1, 2, 128, 32))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(x, x, x)
    q, kp, vp, bt, kvl, _ = _paged_inputs(False)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(kvl))
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(x, x, x, impl="pallas")
    lse = torch.zeros((1, 2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(x, x, x, x, lse, x)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(xb, xb, xb, xb, lse, xb)
    rows = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tln.layernorm(rows, rows[0], rows[0])
    with pytest.raises(ValueError, match="CUDA"):
        tbg.bias_gelu(rows, rows[0])
    with pytest.raises(ValueError, match="CUDA"):
        tlu.lamb_moments(rows, rows, rows, rows, step=1)
    stats = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layernorm_bwd(rows, rows, rows[0], stats, stats)
    with pytest.raises(ValueError, match="CUDA"):
        tbg.bias_gelu_bwd(rows, rows, rows[0])


def test_kernel_wrappers_refuse_float16():
    """The paper's f16 setting: the kernels of the BERT path (flash forward
    and backward, LayerNorm and bias-GELU, forward and backward) take
    float16, so on CPU tensors each wrapper gets past its dtype check and
    refuses the device; the serving kernels (paged decode, wkv6; no
    serving path is f16) and LAMB (fp32 optimizer state) still raise a
    TypeError on f16, before they look at the device."""
    h = torch.zeros((1, 2, 128, 32), dtype=torch.float16)
    lse = torch.zeros((1, 2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(h, h, h)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(h, h, h, h, lse, h)
    rows = torch.zeros((4, 64), dtype=torch.float16)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layernorm(rows, rows[0], rows[0])
    with pytest.raises(ValueError, match="CUDA"):
        tln.layernorm(rows, rows[0].float(), rows[0].float())
    with pytest.raises(ValueError, match="CUDA"):
        tbg.bias_gelu(rows, rows[0])
    stats = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layernorm_bwd(rows, rows, rows[0], stats, stats)
    with pytest.raises(ValueError, match="CUDA"):
        tbg.bias_gelu_bwd(rows, rows, rows[0])
    with pytest.raises(TypeError, match="float16"):
        tlu.lamb_moments(rows, rows, rows, rows, step=1)
    q, kp, vp, bt, kvl, _ = _paged_inputs(False)
    with pytest.raises(TypeError, match="no serving path is f16"):
        tpa.paged_decode_attention(_t(q).half(), _t(kp).half(),
                                   _t(vp).half(), _t(bt), _t(kvl))
    r = torch.zeros((1, 64, 2, 64), dtype=torch.float16)
    with pytest.raises(TypeError, match="no serving path is f16"):
        twkv.wkv6(r, r, r, r.float(), r[0, 0], torch.zeros((1, 2, 64, 64)))


def test_build_names_every_source():
    """Every CUDA source builds into its own content-addressed library."""
    srcs = build.sources()
    assert set(srcs) == {"flash_fwd", "paged_decode", "flash_bwd",
                         "layernorm", "bias_gelu", "lamb_update", "wkv6"}
    for name in srcs:
        path = build.lib_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_headers_enter_the_library_hash(monkeypatch, tmp_path):
    """An edit to a shared header (``csrc/*.cuh``) changes the name of every
    library, so a stale one never loads; a source's own edit changes only
    its own."""
    for f in build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "INCLUDE", tmp_path)
    assert [h.name for h in build.headers()] == ["hopper.cuh", "rows.cuh"]
    before = {name: build.lib_path(name) for name in build.sources()}
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.lib_path(name) for name in build.sources()}
    assert all(before[n] != after[n] for n in before)
    src = tmp_path / "layernorm.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {name: build.lib_path(name) for name in build.sources()}
    assert [n for n in again if again[n] != after[n]] == ["layernorm"]


def test_nvcc_includes_the_package_csrc(monkeypatch, tmp_path):
    """A source built from another directory (a mutated copy under
    ``build/mutants/``) still finds the shared headers: nvcc gets ``-I`` of
    the package's own ``csrc/``, whatever ``CSRC`` points at."""
    real = Path(tfa.__file__).resolve().parents[1] / "csrc"
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    cmd = build.nvcc_command(tmp_path / "flash_fwd.cu", tmp_path / "x.so")
    assert cmd[cmd.index("-I") + 1] == str(real) == str(build.INCLUDE)
    assert cmd[0] == "nvcc" and cmd[-1] == str(tmp_path / "flash_fwd.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd
    for name in ("flash_fwd.cu", "flash_bwd.cu"):
        assert '#include "hopper.cuh"' in (real / name).read_text()


@pytest.mark.parametrize("dtype,dh,code", [
    (torch.bfloat16, 64, 1), (torch.bfloat16, 128, 1),
    (torch.bfloat16, 32, 1), (torch.float32, 64, 0),
    (torch.float16, 64, 2), (torch.float16, 128, 2), (torch.float16, 32, 2)])
def test_forward_launches_are_counted_by_length(monkeypatch, dtype, dh, code):
    """``flash_attention`` passes the library the dtype code and head dim
    the source routes on (16-bit at Dh 64 and 128: the Hopper kernel; at
    32: mma.sync; float32: CUDA cores) and counts each launch, also by q's
    sequence length; ``launch_counts`` reports those and
    ``reset_launch_counts`` clears them.  The library is replaced by a
    stand-in that records its arguments, and the CUDA check by a no-op."""
    calls = []
    monkeypatch.setattr(tfa, "_fn", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(build, "check_cuda", lambda what, **t: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    ops.reset_launch_counts()
    for s in (128, 512, 512):
        q = torch.zeros((2, 4, s, dh), dtype=dtype)
        kv = torch.zeros((2, 2, s, dh), dtype=dtype)
        out, lse = tfa.flash_attention(q, kv, kv, causal=False)
        assert out.shape == q.shape and lse.shape == (2, 4, s)
    assert [(a[0], a[1], a[11], a[12], a[13]) for a in calls] == [
        (code, dh, 128, 128, 0), (code, dh, 512, 512, 0),
        (code, dh, 512, 512, 0)]
    counts = ops.launch_counts()
    assert counts["flash_fwd"] == 3
    assert (counts["flash_fwd_s128"], counts["flash_fwd_s512"]) == (1, 2)
    ops.reset_launch_counts()
    assert not any(k.startswith("flash_fwd_s") for k in ops.launch_counts())


def _bwd_operands(case):
    """(q, k, v, out, lse, dout) on the CPU that the backward kernels must
    refuse for ``case``, and the error expected."""
    b, h, s, dh = 1, 4, 128, 64
    dtype = torch.float16 if case == "float16" else torch.bfloat16
    q = torch.zeros((b, h, s, dh), dtype=dtype)
    kv = torch.zeros((b, 2 if case == "gqa" else h, s, dh), dtype=dtype)
    if case == "misaligned_rows":   # rows of 66 elements, 132 bytes apart
        q = torch.zeros((b, h, s, dh + 2), dtype=dtype)[..., :dh]
    lse = torch.zeros((b, h, s))
    return (q, kv, kv, q, lse, q), {
        "gqa": (ValueError, "head counts"), "float16": (ValueError, "CUDA"),
        "cpu": (ValueError, "CUDA"),
        "misaligned_rows": (ValueError, "16-byte aligned")}[case]


@pytest.mark.parametrize("case", ["gqa", "float16", "cpu",
                                  "misaligned_rows"])
def test_flash_bwd_wrapper_refuses(case):
    """The backward's wrapper checks its operands before the device, so on
    the CPU each refusal shows: GQA (the kernels take equal head counts),
    16-bit rows the kernels cannot move as 16-byte vectors, and -- for
    operands it would take on the card, f16 ones included -- CPU
    tensors."""
    args, (err, match) = _bwd_operands(case)
    with pytest.raises(err, match=match):
        tfa.flash_attention_bwd(*args, causal=False)


@pytest.mark.parametrize("dtype,skv,pitch,acc", [
    (torch.bfloat16, 200, 256, True), (torch.bfloat16, 128, 256, False),
    (torch.float32, 200, 200, False), (torch.float16, 200, 256, True),
    (torch.float16, 128, 256, False), (torch.bfloat16, 512, 256, True)])
def test_flash_bwd_buffers(dtype, skv, pitch, acc):
    """The backward's scratch: per-row fp32 arrays with 16-bit rows padded
    to whole 64-row tiles (the kernels copy them whole), and, only in 16
    bits over more than one 128-key tile, the fp32 dQ partials: one
    (B, H, Sq, Dh) slice a KV tile, which each main-pass block fills for
    its own tile and the post-pass adds in tile order (no atomics, the same
    bits every run); the post-pass is launched only where there are
    partials."""
    q = torch.zeros((2, 3, 200, 64), dtype=dtype)
    delta, lse2, dq_part = tfa.bwd_buffers(q, skv)
    assert delta.shape == (2, 3, pitch) and delta.dtype == torch.float32
    assert delta.stride() == (3 * pitch, pitch, 1)
    assert (lse2 is None) == (dtype == torch.float32)
    if lse2 is not None:
        assert lse2.shape == delta.shape and lse2.stride() == delta.stride()
    assert (dq_part is not None) == acc
    if acc:
        tiles = -(-skv // tfa.KV_TILE)
        assert dq_part.shape == (tiles,) + tuple(q.shape)
        assert dq_part.dtype == torch.float32 and dq_part.is_contiguous()
    assert tfa.bwd_parts((delta, lse2, dq_part)) == (
        tfa.PREP | tfa.MAIN | (tfa.POST if acc else 0))


def test_flash_bwd_kv_tile_matches_the_source():
    """The wrapper's KV_TILE, which decides whether a call needs the dQ
    accumulator, is the key tile that ``csrc/flash_bwd.cu`` declares (and
    there holds both of its bf16 main passes to)."""
    src = (build.CSRC / "flash_bwd.cu").read_text()
    tiles = re.findall(r"constexpr int KV_TILE = (\d+);", src)
    assert tiles == [str(tfa.KV_TILE)] == ["128"]
    assert "static_assert(HC == KV_TILE && BC == KV_TILE" in src


def test_backward_launches_are_counted_by_length(monkeypatch):
    """``bwd_launch`` counts each launch it makes, the main pass also by
    q's sequence length; ``launch_counts`` reports those and
    ``reset_launch_counts`` clears them.  A post-pass without dQ partials
    is refused before the library is called.  The library is
    replaced by a stand-in that records ``parts``."""
    parts = []
    monkeypatch.setattr(tfa, "_bwd_fn",
                        lambda: lambda *a: parts.append(a[0]) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    ops.reset_launch_counts()
    for s in (128, 512, 512):
        q = torch.zeros((1, 2, s, 64), dtype=torch.bfloat16)
        bufs = tfa.bwd_buffers(q, s)
        tfa.bwd_launch(tfa.bwd_parts(bufs), q, q, q, q, torch.zeros((1, 2, s)),
                       q, bufs, (q, q, q), causal=False, window=0,
                       softcap=0.0)
    counts = ops.launch_counts()
    assert parts == [3, 7, 7]
    assert (counts["flash_bwd_prep"], counts["flash_bwd"],
            counts["flash_bwd_post"]) == (3, 3, 2)
    assert (counts["flash_bwd_s128"], counts["flash_bwd_s512"]) == (1, 2)
    q = torch.zeros((1, 2, 128, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="partials"):
        tfa.bwd_launch(tfa.POST, q, q, q, q, torch.zeros((1, 2, 128)), q,
                       tfa.bwd_buffers(q, 128), (q, q, q), causal=False,
                       window=0, softcap=0.0)
    assert parts == [3, 7, 7]
    ops.reset_launch_counts()
    assert not any(k.startswith("flash_bwd_s") for k in ops.launch_counts())


def test_flash_bwd_bound_at_the_training_shapes():
    """``chip_smoke.flash_bwd_bound`` for BERT-large's two attention shapes
    (bf16, bidirectional): 269.5 MB and 85.9 GFLOP at phase 2, so 0.0869 ms
    bound by operations; 134.7 MB and 10.7 GFLOP at phase 1, 0.0402 ms
    bound by bytes."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.TRAIN_ATTN == ((64, 16, 128, 64), (32, 16, 512, 64))
    ms, by = smoke.flash_bwd_bound(*smoke.TRAIN_ATTN[1])
    assert by == "operations" and ms == pytest.approx(0.0869, abs=5e-5)
    ms, by = smoke.flash_bwd_bound(*smoke.TRAIN_ATTN[0])
    assert by == "bytes" and ms == pytest.approx(0.0402, abs=5e-5)
    # causal counts only the S (S + 1) / 2 unmasked pairs: 43.1 GFLOP,
    # 0.0436 ms, so the same bytes (0.0804 ms) bound it
    ms, by = smoke.flash_bwd_bound(32, 16, 512, 64, causal=True)
    assert by == "bytes" and ms == pytest.approx(0.0804, abs=5e-5)


@pytest.mark.parametrize("source,name", [
    (src, name) for src, (_, muts) in sorted(mutation_check.SOURCES.items())
    for name in sorted(muts)])
def test_flash_mutations_edit_only_the_tensor_core_body(source, name):
    """Each deliberately wrong kernel of ``launch/mutation_check.py`` still
    matches its own source: one edit, inside the code it names (the 16-bit
    flash kernels, the LayerNorm and bias-GELU backwards), so the mutants
    calibrate the checks of the kernels that serving (forward) and
    training (backward) run."""
    src = (build.CSRC / f"{source}.cu").read_text()
    body, muts = mutation_check.SOURCES[source]
    old, new = muts[name]
    got = mutation_check.mutate(src, (old, new), body)
    at = src.index(body)
    assert got[:at] == src[:at]
    assert got[at:].count(new) == src[at:].count(new) + 1
    assert len(got) - len(src) == len(new) - len(old)
    assert mutation_check.mutate(src, None, body) == src


# ---------------------------------------------------------------------------
# the training slice's kernels
# ---------------------------------------------------------------------------

# f16 tolerances, between bf16's and f32's: f16 keeps 11 significant bits
# (2**-11 relative rounding) where bf16 keeps 8
F16_TOL = 1e-2          # elementwise, rtol = atol
F16_REL_L2 = 5e-3       # ||got - want|| / ||want||


def _rel_l2(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


@pytest.mark.parametrize("rows,d", [(64, 128), (100, 384), (7, 512),
                                    (1, 128), (300, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_bias_gelu_ref_matches_pallas_kernel(rows, d, dtype):
    """The shapes and tolerances of tests/test_kernels.py:10-22; f16 at
    F16_TOL."""
    rng = np.random.default_rng(rows + d)
    x = jnp.asarray(rng.standard_normal((rows, d)), dtype)
    b = jnp.asarray(rng.standard_normal(d), dtype)
    want = jops.bias_gelu(x, b, impl="pallas_interpret")
    got = ops.bias_gelu(_jt(x), _jt(b))
    assert got.dtype == _jt(x).dtype
    tol = {"float32": 1e-5, "bfloat16": 2e-2, "float16": F16_TOL}[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("rows,d", [(64, 128), (33, 256), (256, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_layernorm_ref_matches_pallas_kernel(rows, d, dtype):
    """The shapes and tolerances of tests/test_kernels.py:25-36 (scale and
    bias in f32), at the Pallas kernel's default eps, f16 at F16_TOL;
    BERT's 1e-12 is held against the reference's own LayerNorm in
    test_torch_layers.py."""
    rng = np.random.default_rng(rows)
    x = jnp.asarray(rng.standard_normal((rows, d)), dtype)
    s = jnp.asarray(1 + 0.1 * rng.standard_normal(d), jnp.float32)
    b = jnp.asarray(0.1 * rng.standard_normal(d), jnp.float32)
    want = jops.layernorm(x, s, b, impl="pallas_interpret")
    got, mean, rstd = ref.layernorm_ref(_jt(x), _jt(s), _jt(b))
    tol = {"float32": 2e-4, "bfloat16": 2e-2, "float16": F16_TOL}[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    xf = np.asarray(x, np.float32)
    np.testing.assert_allclose(mean.numpy(), xf.mean(-1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(xf.var(-1) + 1e-6),
                               rtol=1e-5)


@pytest.mark.parametrize("n", [128, 1000, 65536 + 17])
def test_lamb_moments_ref_matches_pallas_kernel(n):
    """tests/test_kernels.py:74-87's inputs, at rtol 1e-5 / atol 1e-6: the
    moments and update of the fused kernel, then the full leaf update."""
    rng = np.random.default_rng(n)
    w, g = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    m = (0.1 * rng.standard_normal(n)).astype(np.float32)
    v = np.abs(0.1 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(b1=0.9, b2=0.999, eps=1e-6, wd=0.01)
    from repro.kernels import lamb_update as jlu
    want = jlu.lamb_moments(*(jnp.asarray(t) for t in (w, g, m, v)),
                            step=jnp.int32(7), interpret=True, **kw)
    got = ops.lamb_moments(_t(w), _t(g), _t(m), _t(v), step=7, **kw)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-5,
                                   atol=1e-6)
    want = jops.lamb_leaf_update(*(jnp.asarray(t) for t in (w, g, m, v)),
                                 lr=0.01, step=jnp.int32(7),
                                 impl="pallas_interpret", **kw)
    got = ops.lamb_leaf_update(_t(w), _t(g), _t(m), _t(v), lr=0.01, step=7,
                               **kw)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-5,
                                   atol=1e-6)


def _bwd_inputs(seed=0, b=1, h=2, s=256, dh=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, dh)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 30.0),
                                            (64, 30.0)])
def test_flash_bwd_ref_matches_pallas_kernels(causal, window, softcap):
    """The plain FA-2 backward against ``flash_attention_bwd(...,
    interpret=True)`` over tests/test_kernels.py:91-120's matrix, at 3e-4
    (at S = 128: 2 x 2 tiles of 64, so the window crosses tiles); both read
    the same forward (out, lse)."""
    q, k, v, do = _bwd_inputs(s=128)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jq, jk, jv, jdo = (jnp.asarray(t) for t in (q, k, v, do))
    out, lse = jfa.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                   interpret=True, return_lse=True, **kw)
    want = jfa.flash_attention_bwd(jq, jk, jv, out, lse, jdo, block_q=64,
                                   block_k=64, interpret=True, **kw)
    got = ops.flash_attention_bwd(_t(q), _t(k), _t(v), _jt(out), _jt(lse),
                                  _t(do), **kw)
    for a, b_, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=3e-4,
                                   atol=3e-4, err_msg="d" + name)


@pytest.mark.parametrize("causal,window,softcap", [(False, 0, 0.0),
                                                   (True, 48, 30.0)])
def test_flash_autograd_matches_jax_grad_of_naive_attention(causal, window,
                                                            softcap):
    """The port's differentiable flash attention on CPU tensors (plain
    forward, plain FA-2 backward through the autograd.Function) against
    ``jax.grad`` of the reference's ``naive_attention``, at 3e-4; ragged
    S = 200."""
    q, k, v, do = _bwd_inputs(1, b=2, h=2, s=200, dh=32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    t = lambda x: jnp.swapaxes(x, 1, 2)
    f = lambda q, k, v: t(jnaive(t(q), t(k), t(v), **kw))
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    got_out = ops.flash_attention_vjp(tq, tk, tv, **kw)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=2e-4, atol=2e-4)
    got = torch.autograd.grad(got_out, (tq, tk, tv), _t(do))
    for a, b_, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=3e-4,
                                   atol=3e-4, err_msg="d" + name)


def test_layernorm_and_bias_gelu_backward_match_jax_grad():
    """The plain backwards (from the saved statistics / inputs) against
    ``jax.grad`` of the reference's jnp functions, at f32."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    dy = rng.standard_normal((3, 5, 64)).astype(np.float32)
    eps = 1e-12
    _, vjp = jax.vjp(lambda x, s, b: jref.layernorm_ref(x, s, b, eps),
                     *(jnp.asarray(t) for t in (x, s, b)))
    want = vjp(jnp.asarray(dy))
    tx, ts, tb = (_t(t).requires_grad_() for t in (x, s, b))
    y = ops.layernorm(tx, ts, tb, eps=eps)
    got = torch.autograd.grad(y, (tx, ts, tb), _t(dy))
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-5,
                                   atol=1e-5)
    _, vjp = jax.vjp(jref.bias_gelu_ref, jnp.asarray(x), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    tx, tb = _t(x).requires_grad_(), _t(b).requires_grad_()
    got = torch.autograd.grad(ops.bias_gelu(tx, tb), (tx, tb), _t(dy))
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-5,
                                   atol=1e-5)


def test_layernorm_and_bias_gelu_backward_match_jax_grad_in_f16():
    """The plain backwards on f16 tensors (the paper's setting: what the
    kernels are held against on the card) against ``jax.vjp`` of the
    reference's jnp functions in f16, within F16_TOL elementwise and
    F16_REL_L2.  Both compute in fp32 from the f16 inputs and round each
    gradient once, except where the reference rounds on the way: its
    ``bias_gelu_ref`` adds x + b in f16 before it upcasts."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 5, 64)).astype(np.float16)
    s = (1 + 0.1 * rng.standard_normal(64)).astype(np.float16)
    b = (0.1 * rng.standard_normal(64)).astype(np.float16)
    dy = rng.standard_normal((3, 5, 64)).astype(np.float16)
    eps = 1e-12
    _, vjp = jax.vjp(lambda x, s, b: jref.layernorm_ref(x, s, b, eps),
                     *(jnp.asarray(t) for t in (x, s, b)))
    want = vjp(jnp.asarray(dy))
    tx, ts, tb = (_t(t).requires_grad_() for t in (x, s, b))
    got = torch.autograd.grad(ops.layernorm(tx, ts, tb, eps=eps),
                              (tx, ts, tb), _t(dy))
    _, vjp = jax.vjp(jref.bias_gelu_ref, jnp.asarray(x), jnp.asarray(b))
    tx, tb = _t(x).requires_grad_(), _t(b).requires_grad_()
    got += torch.autograd.grad(ops.bias_gelu(tx, tb), (tx, tb), _t(dy))
    want += vjp(jnp.asarray(dy))
    for a, b_, name in zip(got, want, ("ln dx", "ln dscale", "ln dbias",
                                       "gelu dx", "gelu db")):
        assert a.dtype == torch.float16, name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b_, np.float32), rtol=F16_TOL,
                                   atol=F16_TOL, err_msg=name)
        assert _rel_l2(a.float().numpy(), b_) <= F16_REL_L2, name


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_pallas_kernels_in_f16(causal):
    """The plain flash forward and FA-2 backward on f16 tensors against the
    Pallas kernels run in f16 in interpret mode (``flash_attention`` and
    ``flash_attention_bwd(..., interpret=True)``), S = 128 in 64-row tiles,
    Dh 64 (BERT's): out, lse, dq, dk and dv within F16_TOL elementwise and
    F16_REL_L2.  The Pallas kernels round P and dS to f16 inside; the plain
    versions keep them in fp32."""
    q, k, v, do = (t.astype(np.float16) for t in _bwd_inputs(3, s=128))
    jq, jk, jv, jdo = (jnp.asarray(t) for t in (q, k, v, do))
    out, lse = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                   block_k=64, interpret=True,
                                   return_lse=True)
    got_out, got_lse = ops.flash_attention(_t(q), _t(k), _t(v),
                                           causal=causal)
    assert got_out.dtype == torch.float16
    want = jfa.flash_attention_bwd(jq, jk, jv, out, lse, jdo, causal=causal,
                                   block_q=64, block_k=64, interpret=True)
    got = ops.flash_attention_bwd(_t(q), _t(k), _t(v), _jt(out), _jt(lse),
                                  _t(do), causal=causal)
    pairs = [(got_out, out, "out"), (got_lse, lse, "lse")] + [
        (g, w, "d" + n) for g, w, n in zip(got, want, "qkv")]
    for g, w, name in pairs:
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=F16_TOL,
                                   atol=F16_TOL, err_msg=name)
        assert _rel_l2(g.float().numpy(), w) <= F16_REL_L2, name


def _row_bwd_call(kernel, case):
    """A call of ``layernorm_bwd`` or ``bias_gelu_bwd`` on CPU tensors that
    the wrapper must refuse for ``case``, and the error expected."""
    x = torch.zeros((4, 64))
    dy = x.clone()
    if case == "misaligned_rows":      # 4 bytes off a 16-byte boundary
        x = torch.zeros(4 * 64 + 1)[1:].view(4, 64)
    if case == "mismatched_dtypes":
        dy = dy.to(torch.bfloat16)
    if kernel == "layernorm_bwd":
        stats = torch.zeros(4)
        call = lambda: tln.layernorm_bwd(dy, x, torch.ones(64), stats, stats)
    else:
        call = lambda: tbg.bias_gelu_bwd(dy, x, torch.zeros(64))
    return call, {"cpu": (ValueError, "CUDA"),
                  "misaligned_rows": (ValueError, "16-byte aligned"),
                  "mismatched_dtypes": (TypeError, "dtype|float32")}[case]


@pytest.mark.parametrize("case", ["cpu", "misaligned_rows",
                                  "mismatched_dtypes"])
@pytest.mark.parametrize("kernel", ["layernorm_bwd", "bias_gelu_bwd"])
def test_row_bwd_wrappers_refuse(kernel, case):
    """The new backward wrappers check dtypes, shapes and alignment before
    the device, so on the CPU each refusal shows: rows the kernel cannot
    read as 16-byte vectors, dy of another dtype than x, and -- for
    operands it would take on the card -- CPU tensors."""
    call, (err, match) = _row_bwd_call(kernel, case)
    with pytest.raises(err, match=match):
        call()


def test_layernorm_bwd_tiles():
    """The LayerNorm backward's row tiles: at most 132 (one wave of one
    block an SM on an H100; one fp32 partial row each, summed in tile
    order), each 8 warps of the same number of consecutive rows; a
    function of the row count alone, so the order of every sum is too."""
    assert tln.bwd_tiles(16384) == (128, 128)    # phase 2: 32 x 512
    assert tln.bwd_tiles(8192) == (128, 64)      # phase 1: 64 x 128
    assert tln.bwd_tiles(2560) == (107, 24)      # MLM head, phase 2
    assert tln.bwd_tiles(1280) == (80, 16)       # MLM head, phase 1
    assert tln.bwd_tiles(7) == (1, 8)


@pytest.mark.parametrize("dtype,pdtype,codes,nv", [
    (torch.float16, torch.float32, (2, 0), 1),
    (torch.bfloat16, torch.bfloat16, (1, 1), 1),
    (torch.float32, torch.float32, (0, 0), 2)])
def test_row_bwd_wrappers_pass_the_kernel_its_tiles(monkeypatch, dtype,
                                                    pdtype, codes, nv):
    """``layernorm_bwd`` and ``bias_gelu_bwd`` pass the library the dtype
    codes (f16 = 2) and vectors a lane the sources route on, the row tile
    and a partial buffer of one fp32 row a tile, allocate outputs in x's
    and the parameters' dtypes and count one launch a call.  The library is
    replaced by a stand-in that records its arguments, the CUDA check by a
    no-op."""
    calls = []
    rec = lambda *a: calls.append(a) or 0
    for mod in (tln, tbg):
        monkeypatch.setattr(mod, "_bwd_fn", lambda: rec)
    monkeypatch.setattr(build, "check_cuda", lambda what, **t: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    parts = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: parts.append(
        (a, k.get("dtype"))) or empty(*a, **k))
    ops.reset_launch_counts()
    rows, d = 300, 256
    x = torch.zeros((3, 100, d), dtype=dtype)
    stats = torch.zeros(rows)
    dx, dscale, dbias = tln.layernorm_bwd(x, x, torch.ones(d, dtype=pdtype),
                                          stats, stats)
    assert (dx.shape, dx.dtype) == (x.shape, dtype)
    assert dscale.dtype == dbias.dtype == pdtype and dscale.shape == (d,)
    a = calls[-1]
    tiles, tile = tln.bwd_tiles(rows)
    assert (a[0], a[1], a[2], a[-4], a[-3], a[-2]) == (*codes, nv, rows, d,
                                                       tile)
    assert ((tiles, 2 * d),) in [p[0] for p in parts if p[1] ==
                                 torch.float32]
    dx, db = tbg.bias_gelu_bwd(x, x, torch.zeros(d, dtype=dtype))
    assert (dx.shape, dx.dtype, db.shape, db.dtype) == (x.shape, dtype, (d,),
                                                        dtype)
    a = calls[-1]
    assert (a[0], a[-4], a[-3], a[-2]) == (codes[0], rows, d, tbg.TILE_ROWS)
    assert ((-(-rows // tbg.TILE_ROWS), d),) in [
        p[0] for p in parts if p[1] == torch.float32]
    counts = ops.launch_counts()
    assert (counts["layernorm_bwd"], counts["bias_gelu_bwd"]) == (1, 1)
    ops.reset_launch_counts()
    assert ops.launch_counts()["layernorm_bwd"] == 0


def test_row_backwards_go_through_the_dispatchers(monkeypatch):
    """The LayerNorm and bias-GELU autograd functions call
    ``ops.layernorm_bwd`` and ``ops.bias_gelu_bwd`` by name at call time,
    with the forward's ``impl``, so chip_smoke.py's per-call hold sees every
    backward call; the LayerNorm backward runs inside the profiler span
    that launch/profile_train.py reads."""
    seen = []
    for name in ("layernorm_bwd", "bias_gelu_bwd"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=fn, **k: (
            seen.append((_n, k.get("impl"))) or _f(*a, **k)))
    x = torch.randn(6, 64, requires_grad=True)
    sc, bi = (torch.ones(64, requires_grad=True),
              torch.zeros(64, requires_grad=True))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = ops.layernorm(x, sc, bi, impl="torch")
        (ops.bias_gelu(y, bi) * 2).sum().backward()
    assert seen == [("bias_gelu_bwd", None), ("layernorm_bwd", "torch")]
    assert ops.LAYERNORM_BWD_SPAN in {e.key for e in prof.key_averages()}


def _jt(x):
    """A JAX array as a torch tensor of the same dtype (bf16 included)."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))
