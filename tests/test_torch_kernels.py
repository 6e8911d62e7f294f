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
    qg = q.clone().requires_grad_()
    ops.flash_attention_vjp(qg, k, v, causal=True).sum().backward()
    assert ops.launch_counts() == {
        "flash_fwd": 0, "flash_bwd_prep": 0, "flash_bwd": 0,
        "flash_bwd_post": 0, "paged_decode": 0, "layernorm": 0,
        "bias_gelu": 0, "lamb_moments": 0, "wkv6": 0}


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


def test_kernel_wrappers_refuse_float16():
    """No kernel takes f16 yet: each new wrapper raises on it (before it
    looks at the device), so an f16 run cannot reach a kernel by mistake."""
    h = torch.zeros((1, 2, 128, 32), dtype=torch.float16)
    lse = torch.zeros((1, 2, 128))
    with pytest.raises(TypeError, match="float16"):
        tfa.flash_attention(h, h, h)
    with pytest.raises(TypeError, match="float16"):
        tfa.flash_attention_bwd(h, h, h, h, lse, h)
    rows = torch.zeros((4, 64), dtype=torch.float16)
    with pytest.raises(TypeError, match="float16"):
        tln.layernorm(rows, rows[0], rows[0])
    with pytest.raises(TypeError, match="float16"):
        tbg.bias_gelu(rows, rows[0])
    with pytest.raises(TypeError, match="float16"):
        tlu.lamb_moments(rows, rows, rows, rows, step=1)


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
    assert [h.name for h in build.headers()] == ["hopper.cuh"]
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
    (torch.bfloat16, 32, 1), (torch.float32, 64, 0)])
def test_forward_launches_are_counted_by_length(monkeypatch, dtype, dh, code):
    """``flash_attention`` passes the library the dtype code and head dim
    the source routes on (bf16 at Dh 64 and 128: the Hopper kernel; bf16 at
    32: mma.sync; float32: CUDA cores) and counts each launch, also by q's
    sequence length; ``launch_counts`` reports those and
    ``reset_launch_counts`` clears them.  The library is replaced by a
    stand-in that records its arguments, and the CUDA check by a no-op."""
    calls = []
    monkeypatch.setattr(tfa, "_fn", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(tfa, "_check_cuda", lambda what, **t: None)
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
        "gqa": (ValueError, "head counts"), "float16": (TypeError, "float16"),
        "cpu": (ValueError, "CUDA"),
        "misaligned_rows": (ValueError, "16-byte aligned")}[case]


@pytest.mark.parametrize("case", ["gqa", "float16", "cpu",
                                  "misaligned_rows"])
def test_flash_bwd_wrapper_refuses(case):
    """The backward's wrapper checks its operands before the device, so on
    the CPU each refusal shows: GQA (the kernels take equal head counts),
    f16, bf16 rows the kernels cannot move as 16-byte vectors, and -- for
    operands it would take on the card -- CPU tensors."""
    args, (err, match) = _bwd_operands(case)
    with pytest.raises(err, match=match):
        tfa.flash_attention_bwd(*args, causal=False)


@pytest.mark.parametrize("dtype,skv,pitch,acc", [
    (torch.bfloat16, 200, 256, True), (torch.bfloat16, 128, 256, False),
    (torch.float32, 200, 200, False)])
def test_flash_bwd_buffers(dtype, skv, pitch, acc):
    """The backward's scratch: per-row fp32 arrays with bf16 rows padded to
    whole 64-row tiles (the kernels copy them whole), and the fp32 dQ
    accumulator only in bf16 over more than one 128-key tile; the
    post-pass is launched only where there is an accumulator."""
    q = torch.zeros((2, 3, 200, 64), dtype=dtype)
    delta, lse2, dq_acc = tfa.bwd_buffers(q, skv)
    assert delta.shape == (2, 3, pitch) and delta.dtype == torch.float32
    assert delta.stride() == (3 * pitch, pitch, 1)
    assert (lse2 is None) == (dtype == torch.float32)
    if lse2 is not None:
        assert lse2.shape == delta.shape and lse2.stride() == delta.stride()
    assert (dq_acc is not None) == acc
    if acc:
        assert dq_acc.shape == q.shape and dq_acc.is_contiguous()
    assert tfa.bwd_parts((delta, lse2, dq_acc)) == (
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
    ``reset_launch_counts`` clears them.  A post-pass without an
    accumulator is refused before the library is called.  The library is
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
    with pytest.raises(ValueError, match="accumulator"):
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
    """Each deliberately wrong flash kernel of ``launch/mutation_check.py``
    still matches its own source: one edit, inside the bf16 tensor-core
    code, so the mutants calibrate the checks of the kernels that serving
    (forward) and training (backward) run."""
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

@pytest.mark.parametrize("rows,d", [(64, 128), (100, 384), (7, 512),
                                    (1, 128), (300, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_gelu_ref_matches_pallas_kernel(rows, d, dtype):
    """The shapes and tolerances of tests/test_kernels.py:10-22."""
    rng = np.random.default_rng(rows + d)
    x = jnp.asarray(rng.standard_normal((rows, d)), dtype)
    b = jnp.asarray(rng.standard_normal(d), dtype)
    want = jops.bias_gelu(x, b, impl="pallas_interpret")
    got = ops.bias_gelu(_jt(x), _jt(b))
    assert got.dtype == _jt(x).dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("rows,d", [(64, 128), (33, 256), (256, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_ref_matches_pallas_kernel(rows, d, dtype):
    """The shapes and tolerances of tests/test_kernels.py:25-36 (scale and
    bias in f32), at the Pallas kernel's default eps; BERT's 1e-12 is held
    against the reference's own LayerNorm in test_torch_layers.py."""
    rng = np.random.default_rng(rows)
    x = jnp.asarray(rng.standard_normal((rows, d)), dtype)
    s = jnp.asarray(1 + 0.1 * rng.standard_normal(d), jnp.float32)
    b = jnp.asarray(0.1 * rng.standard_normal(d), jnp.float32)
    want = jops.layernorm(x, s, b, impl="pallas_interpret")
    got, mean, rstd = ref.layernorm_ref(_jt(x), _jt(s), _jt(b))
    tol = 2e-4 if dtype == "float32" else 2e-2
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


def _jt(x):
    """A JAX array as a torch tensor of the same dtype (bf16 included)."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))
