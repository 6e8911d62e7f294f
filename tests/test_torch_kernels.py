"""The port's kernel plain versions against the JAX Pallas kernels (run in
interpret mode on the CPU), and the device dispatch of the kernel wrappers.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as tfa
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
    assert ops.launch_counts() == {"flash_fwd": 0, "paged_decode": 0}


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


def test_build_names_every_source():
    """Every CUDA source builds into its own content-addressed library."""
    srcs = build.sources()
    assert set(srcs) == {"flash_fwd", "paged_decode"}
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
