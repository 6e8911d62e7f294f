"""The port's kernel plain versions against the JAX Pallas kernels (run in
interpret mode on the CPU), and the device dispatch of the kernel wrappers.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there."""
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
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "paged_decode": 0, "layernorm": 0, "bias_gelu": 0,
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
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dkv(x, x, x, x, lse, lse)
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
        tfa.flash_attention_bwd_dq(h, h, h, h, lse, lse)
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


@pytest.mark.parametrize("name", sorted(mutation_check.MUTATIONS))
def test_flash_mutations_edit_only_the_tensor_core_body(name):
    """Each deliberately wrong flash kernel of ``launch/mutation_check.py``
    still matches the source: one edit, inside the bf16 tensor-core body,
    so the mutants calibrate the check of the kernel that serving runs."""
    src = (build.CSRC / "flash_fwd.cu").read_text()
    old, new = mutation_check.MUTATIONS[name]
    got = mutation_check.mutate(src, (old, new))
    at = src.index("flash_fwd_mma_kernel(const")
    assert got[:at] == src[:at]
    assert got[at:].count(new) == src[at:].count(new) + 1
    assert len(got) - len(src) == len(new) - len(old)
    assert mutation_check.mutate(src, None) == src


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
