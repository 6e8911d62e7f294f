"""Shared model, weights and helpers of the port's whisper-small tests
(``tests/test_torch_whisper.py``, ``test_torch_whisper_serve.py``,
``test_torch_whisper_train.py``).

The model is whisper-small's smoke variant at two blocks: 2 encoder and 2
decoder layers, d 256, 4 heads of 32, vocab 512, 16 frames, learned
decoder positions (4096), LayerNorm, the GELU MLP, tied embeddings.
Weights are the port's init carried across as numpy
(``bridge.params_to_numpy``: the reference's jitted init of the same tree
takes longer than a test file's budget allows), with every norm scale at
1 + 0.1 N(0, 1), every norm bias and MLP bias at 0.1 N(0, 1) (the init's
zeros and ones would let a missing bias or scale agree) and the learned
decoder positions at 10x (so that a token embedded at the wrong position
moves the logits well past the tolerances).  Inputs are drawn with numpy
from a seed; frames are 0.1 N(0, 1), as the reference's trainer draws
them."""
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

ARCH = "whisper-small"
JPOL, POL = jmake_policy("f32"), make_policy("f32")
# f32 logits and activations: summation order only
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
POS_GAIN = 10.0


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(
                np.float32)
        if name.endswith(("['bias']", "['bi']", "['bo']")):
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name.endswith("['embed']['pos']"):
            return (POS_GAIN * x).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def model(n_blocks=2):
    """(reference config, port config, JAX params, port params) of the
    smoke variant at ``n_blocks`` blocks (as many encoder layers: the
    smoke variant's 2), the same perturbed weights on both sides."""
    jcfg = jsmoke(jget_config(ARCH), n_blocks=n_blocks)
    cfg = smoke_variant(get_config(ARCH), n_blocks=n_blocks)
    npp = perturbed(bridge.params_to_numpy(
        T.init_model(cfg, seed=0, device="cpu"), cfg), seed=1)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, npp),
            bridge.params_from_jax(npp, cfg, device="cpu"))


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def frames(cfg, batch, seed):
    """(batch, enc_seq, d_model) float32 frame embeddings."""
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (batch, cfg.enc_seq, cfg.d_model))).astype(np.float32)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))
