"""Shared model, weights and helpers of the port's qwen2-vl-7b tests
(``tests/test_torch_qwen2vl.py``, ``test_torch_qwen2vl_serve.py``,
``test_torch_qwen2vl_train.py``).

The model is qwen2-vl-7b's smoke variant at two blocks: 2 layers, d 256,
4 query heads of 32 over 1 KV head, M-RoPE sections (8, 4, 4), 8 vision
tokens, QKV biases, RMSNorm, SwiGLU, an untied head, vocab 512.  Weights
are the port's init carried across as numpy (``bridge.params_to_numpy``),
with every norm scale at 1 + 0.1 N(0, 1) and every QKV bias at 0.5 N(0, 1)
(the init's ones and zeros would let a missing scale or bias agree).
Inputs are drawn with numpy from a seed: vision embeddings 0.1 N(0, 1),
as the reference's trainer draws them, and distinct position triples,
each axis its own random positions (so that a section read from the wrong
axis moves the logits)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.amp import make_policy as jmake_policy
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.amp import make_policy
from repro_torch.models import transformer as T

ARCH = "qwen2-vl-7b"
JPOL, POL = jmake_policy("f32"), make_policy("f32")
# f32 logits and activations: summation order only
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BIAS_STD = 0.5


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(
                np.float32)
        if name.endswith(("['bq']", "['bk']", "['bv']")):
            return (BIAS_STD * rng.standard_normal(x.shape)).astype(
                np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def model(n_blocks=2):
    """(reference config, port config, JAX params, port params) of the
    smoke variant at ``n_blocks`` layers, the same perturbed weights on
    both sides."""
    jcfg = jsmoke(jget_config(ARCH), n_blocks=n_blocks)
    cfg = smoke_variant(get_config(ARCH), n_blocks=n_blocks)
    npp = perturbed(bridge.params_to_numpy(
        T.init_model(cfg, seed=0, device="cpu"), cfg), seed=1)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, npp),
            bridge.params_from_jax(npp, cfg, device="cpu"))


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def vision(cfg, batch, seed):
    """(batch, n_vision_tokens, d_model) float32 patch embeddings."""
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)


def triples(batch, seq, seed, high=4096):
    """(3, batch, seq) int32 positions, each axis drawn on its own, up to
    ``high``: the height and width sections hold the slowest frequencies
    (theta 1e6: slot 12 of 16 turns 3e-5 rad a position), which positions
    in the tens leave all but still."""
    return np.random.default_rng(seed).integers(
        0, high, (3, batch, seq)).astype(np.int32)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))
