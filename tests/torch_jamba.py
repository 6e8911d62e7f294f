"""Shared weights, helpers and tolerances of the port's jamba tests
(``tests/test_torch_jamba_serve.py``, ``tests/test_torch_jamba_slots.py``).

The model is jamba-1.5-large-398b's smoke variant (d 256, 4 query heads
over 1 KV head, d_inner 512, 4 experts top-2): its 8-layer block, or its
first 4 layers ((attn, dense), (mamba, moe), (mamba, dense), (mamba,
moe): the cut served on the card).  Weights are the reference's init,
every norm scale at 1 + 0.1 N(0, 1), the router's weights times 5 and the
mamba projections scaled up (in_proj 10x, x_proj 5x, out_proj 50x), so
that neither the norms, the routing nor the mamba mixers can agree by
being ones, near-uniform or ~1e-5 (at tests/test_torch_mamba.py's larger
gains, stacked over 7 mamba layers, dt grows until the ssm rows amplify
summation-order differences 100-fold between layers 1 and 5); they cross
over through ``bridge.params_from_jax``.

f32 logits within LOGIT_TOL (summation order only), int8 pages within
INT8_LOGIT_BOUND, recurrent rows within the state tolerance: rtol 1e-4
and an absolute part of 1e-3 of the rows' RMS (the conv rows are O(3) and
the ssm rows O(1e-2) here; summation order moves both by up to ~8e-5 of
their RMS over 8 layers; the mixer alone is held at 1e-4 / 1e-5 in
tests/test_torch_mamba.py)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.amp import make_policy as jmake_policy
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import cut_depth, get_config, smoke_variant
from repro_torch.core.amp import make_policy

ARCH = "jamba-1.5-large-398b"
JPOL, POL = jmake_policy("f32"), make_policy("f32")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_RTOL, STATE_ATOL_OF_RMS = 1e-4, 1e-3
INT8_LOGIT_BOUND = 1e-2
ROUTER_GAIN = 5.0
MAMBA_GAINS = {"in_proj": 10.0, "x_proj": 5.0, "out_proj": 50.0}
RECURRENT = ("conv", "ssm")
LAYERS = (8, 4)


def jcut(jcfg, layers):
    """The reference config's first ``layers`` layers (``cut_depth``'s
    twin)."""
    if layers >= len(jcfg.block_pattern):
        return jcfg
    return dataclasses.replace(jcfg, n_layers=layers,
                               block_pattern=jcfg.block_pattern[:layers])


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(
                np.float32)
        if name.endswith("['router']"):
            return (ROUTER_GAIN * x).astype(np.float32)
        for k, g in MAMBA_GAINS.items():
            if name.endswith(f"['mixer']['{k}']"):
                return (g * x).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def model(layers=8, pattern=None):
    """(reference config, port config, JAX params, port params) of the
    smoke variant cut to ``layers`` (or with ``pattern`` as its block),
    the same perturbed weights on both sides."""
    jcfg = jcut(jsmoke(jget_config(ARCH)), layers)
    cfg = cut_depth(smoke_variant(get_config(ARCH)), layers)
    if pattern is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=len(pattern),
                                   block_pattern=pattern)
        cfg = dataclasses.replace(cfg, n_layers=len(pattern),
                                  block_pattern=pattern)
    jp = jax.jit(lambda key: JT.init_model(key, jcfg)[0])(
        jax.random.PRNGKey(0))
    np_params = perturbed(jp, seed=1)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, np_params),
            bridge.params_from_jax(np_params, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def jdecode(layers):
    return jax.jit(functools.partial(JT.decode_step, cfg=model(layers)[0],
                                     policy=JPOL, moe_impl="dense"))


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def close(got, want, **tol):
    """A port tensor against the reference's, within ``tol`` or else the
    state tolerance."""
    want = np.asarray(want)
    if not tol:
        rms = float(np.sqrt(np.mean(np.square(want, dtype=np.float64))))
        tol = dict(rtol=STATE_RTOL, atol=STATE_ATOL_OF_RMS * rms)
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


def assert_states_close(tstate, jstate, rows=slice(None), cache=True):
    """Every layer's recurrent rows (and attention K/V of a contiguous
    cache) of the port's state against the reference's stacked one (one
    block), at the batch rows ``rows``."""
    for i, st in enumerate(tstate["blocks"]):
        jst = jstate["blocks"][i]
        for key in RECURRENT:
            if key in st:
                close(st[key][rows], np.asarray(jst[key])[0][rows])
        if cache and "k" in st.get("cache", {}):
            for key in ("k", "v"):
                close(st["cache"][key][rows],
                      np.asarray(jst["cache"][key])[0][rows], **LOGIT_TOL)


def paged_cfg(mod, mode, ps=4, num_pages=13):
    if mode == "contiguous":
        return None
    return mod.PagedCacheConfig(page_size=ps, num_pages=num_pages,
                                quantized=mode == "paged_int8")
