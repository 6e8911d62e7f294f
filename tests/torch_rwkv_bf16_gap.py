"""How far rwkv6-1.6b's bf16 gradients lie from its f32 ones, in the JAX
package and in the port, on the same weights and tokens.

For each gradient group (a leaf name over every layer) the gap is
||g_bf16 - g_f32|| / ||g_f32||: what bf16 arithmetic makes of the
gradient.  The reference is taken twice: under ``jax.jit`` (XLA fuses
elementwise chains and keeps their intermediates in f32 on the CPU) and
op by op under ``jax.disable_jit`` (every bf16 op rounded, as eager
PyTorch rounds).  The port runs eagerly, with the recompute as training
runs it.  Weights: the reference's init (``jax.random.PRNGKey(seed)``,
under ``jax.jit`` either way), bridged with ``bridge.params_from_jax``;
tokens drawn with numpy from the seed.

Run from the repository root (CPU; the sizes are the smoke variant's
knobs)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_rwkv_bf16_gap.py \
        --layers 1 2 4 --d-model 512 --batch 4 --seq 128 --seeds 1 2

prints one table per depth and seed and, per depth, the median over
groups of each gap.  With ``--time-mix`` it takes one time mix alone at
rwkv6-1.6b's full width instead (the port's init, ``--seq`` tokens of
unit normal inputs, a unit normal output gradient): the port's gaps, the
reference's on the same weights (jit and op by op) and the port's with
the per-head group norm's epsilon raised to 1e6, which turns its
1 / sqrt(var + eps) into a constant::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_rwkv_bf16_gap.py \
        --time-mix --batch 2 --seq 256

``tests/test_torch_rwkv_train.py`` holds the port's gaps against the
reference's at a small size.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core import amp as jamp
from repro.models import api as japi
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import amp
from repro_torch.models import api
from repro_torch.utils import tree_leaves, tree_map


def _groups(pairs):
    """[(path, array)] -> {group: every layer's elements, float64}; the
    group is the path without its layer indices."""
    out = {}
    for path, a in pairs:
        key = ".".join(str(p) for p in path if not isinstance(p, int))
        out.setdefault(key, []).append(np.asarray(a, np.float64).ravel())
    return {k: np.concatenate(v) for k, v in out.items()}


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, pre + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, pre + (i,))
    else:
        yield pre, tree


def rel(a, b) -> float:
    """||a - b|| / ||b||."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def gaps(layers: int, d_model: int, batch: int, seq: int, vocab: int = 512,
         seed: int = 1) -> dict:
    """{"ref_jit" | "ref_op" | "port": {group: gap}} and, under "f32",
    {group: ||port f32 - ref f32|| / ||ref f32||}."""
    jcfg = jsmoke(jget_config("rwkv6-1.6b"), d_model=d_model,
                  n_blocks=layers, vocab=vocab)
    cfg = smoke_variant(get_config("rwkv6-1.6b"), d_model=d_model,
                        n_blocks=layers, vocab=vocab)
    jp = jax.jit(lambda key: japi.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tokens = np.random.default_rng(seed).integers(
        0, vocab, (batch, seq + 1)).astype(np.int32)

    def ref(prec):
        pol = jamp.make_policy(prec)
        g = jax.grad(lambda p, t: japi.lm_train_loss(
            p, {"tokens": t}, jcfg, pol, remat=True)[0])
        return g

    def ref_jit(prec):
        g = jax.jit(ref(prec))(jp, jnp.asarray(tokens))
        return _groups(_paths(jax.tree_util.tree_map(np.asarray, g)))

    def ref_op(prec):
        with jax.disable_jit():
            g = ref(prec)(jp, jnp.asarray(tokens))
        return _groups(_paths(jax.tree_util.tree_map(np.asarray, g)))

    def port(prec):
        params = bridge.params_from_jax(np_params, cfg, device="cpu")
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = api.lm_train_loss(
            params, api.to_device({"tokens": tokens}, "cpu"), cfg,
            amp.make_policy(prec), remat=True)
        loss.backward()
        return _groups(_paths(tree_map(lambda t: t.grad.double().numpy(),
                                       params)))

    out = {}
    f32 = {}
    for name, fn in (("ref_jit", ref_jit), ("ref_op", ref_op),
                     ("port", port)):
        f32[name], bf16 = fn("f32"), fn("bf16")
        out[name] = {k: rel(bf16[k], f32[name][k]) for k in f32[name]}
    out["f32"] = {k: rel(f32["port"][k], f32["ref_jit"][k])
                  for k in f32["port"]}
    return out


def time_mix_gaps(d_model: int = 2048, batch: int = 2, seq: int = 256,
                  seed: int = 1, op_by_op: bool = True) -> dict:
    """One time mix of rwkv6-1.6b at width ``d_model``: {"port" |
    "ref_jit" | "ref_op" | "port_flat_norm": {leaf: gap}}, the last with
    the group norm's epsilon at 1e6 (its scale a constant); "ref_op" only
    with ``op_by_op``."""
    from repro.models import rwkv as JR
    from repro_torch.models import rwkv as RW
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=1,
                              d_model=d_model, vocab_size=512)
    jcfg = dataclasses.replace(jget_config("rwkv6-1.6b"), n_layers=1,
                               d_model=d_model, vocab_size=512)
    params = api.init_params(cfg, seed=seed, device="cpu")
    params = params["blocks"][0]["mixer"]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, d_model)).astype(np.float32)
    dy = rng.standard_normal((batch, seq, d_model)).astype(np.float32)

    def port(prec):
        pol = amp.make_policy(prec)
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        y, _ = RW.apply_time_mix(p, torch.from_numpy(x).to(pol.compute_dtype),
                                 cfg, pol)
        (y.float() * torch.from_numpy(dy)).sum().backward()
        return {k: v.grad.double().numpy() for k, v in p.items()}

    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}

    def ref(prec, jit):
        pol = jamp.make_policy(prec)
        g = jax.grad(lambda p, xx: jnp.sum(JR.apply_time_mix(
            p, xx.astype(pol.compute_dtype), jcfg, pol)[0]
            .astype(jnp.float32) * dy))
        if jit:
            out = jax.jit(g)(jp, jnp.asarray(x))
        else:
            with jax.disable_jit():
                out = g(jp, jnp.asarray(x))
        return {k: np.asarray(v, np.float64) for k, v in out.items()}

    out = {}
    runs = [("port", port), ("ref_jit", lambda prec: ref(prec, True))]
    if op_by_op:
        runs.append(("ref_op", lambda prec: ref(prec, False)))
    for name, fn in runs:
        f32, bf16 = fn("f32"), fn("bf16")
        out[name] = {k: rel(bf16[k], f32[k]) for k in f32}
    eps, RW.GN_EPS = RW.GN_EPS, 1e6
    try:
        f32, bf16 = port("f32"), port("bf16")
    finally:
        RW.GN_EPS = eps
    out["port_flat_norm"] = {k: rel(bf16[k], f32[k]) for k in f32}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--time-mix", action="store_true")
    args = ap.parse_args(argv)
    if args.time_mix:
        for seed in args.seeds:
            g = time_mix_gaps(batch=args.batch, seq=args.seq, seed=seed)
            print(f"\ntime mix at width 2048, {args.batch} x {args.seq} "
                  f"tokens, seed {seed}")
            print(f"{'leaf':12s} " + " ".join(f"{n:>14s}" for n in g))
            for k in sorted(g["port"], key=lambda k: -g["port"][k]):
                print(f"{k:12s} " + " ".join(f"{g[n][k]:14.3e}" for n in g))
        return
    for layers in args.layers:
        medians = {"ref_jit": [], "ref_op": [], "port": []}
        for seed in args.seeds:
            g = gaps(layers, args.d_model, args.batch, args.seq, args.vocab,
                     seed)
            print(f"\n{layers} layers, width {args.d_model}, {args.batch} x "
                  f"{args.seq} tokens, vocab {args.vocab}, seed {seed}")
            print(f"{'group':28s} {'ref jit':>10s} {'ref op':>10s} "
                  f"{'port':>10s} {'f32 p/r':>10s}")
            for k in sorted(g["port"], key=lambda k: -g["port"][k]):
                print(f"{k:28s} {g['ref_jit'][k]:10.3e} "
                      f"{g['ref_op'][k]:10.3e} {g['port'][k]:10.3e} "
                      f"{g['f32'][k]:10.3e}")
            for name in medians:
                medians[name].append(statistics.median(g[name].values()))
        print(f"\n{layers} layers: median gap over groups, per seed: "
              + "; ".join(f"{n} " + ", ".join(f"{m:.3e}" for m in ms)
                          for n, ms in medians.items()))


if __name__ == "__main__":
    main()
