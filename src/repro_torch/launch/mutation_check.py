"""Would ``chip_smoke.py``'s per-call and model-level checks see a subtly
wrong kernel?

  PYTHONPATH=src python -m repro_torch.launch.mutation_check

Families of deliberately wrong kernels, each a set of one-line edits
inside the code of one source that the main paths run:

* ``MUTATIONS`` edit ``csrc/flash_fwd.cu`` (``flash_fwd_hopper_kernel``,
  the 16-bit forward at Dh 64 and 128 that serving and training run).
  Each copy runs ``chip_smoke.path_parity`` on full-width deepseek-7b in
  bf16 with a paged cache: one request's prefill and 4 decode steps
  through the kernels and through the plain versions.
* ``PAGED_MUTATIONS`` edit ``csrc/paged_decode.cu``
  (``paged_decode_split_kernel``, the 16-bit and int8 paged decode that
  serving runs).  Each copy runs ``chip_smoke.path_parity`` as the
  forward's do, in the ``paged`` and the ``paged_int8`` cache modes, judged
  by ``chip_smoke.check_parity`` (every paged call within TOL of its
  inputs' plain version, and the logits bound); a copy is caught if either
  mode fails.  One slot's 32 heads leave SMs idle, so the split plan cuts
  its 65-page table in four and the request's 777-789 tokens fill three
  splits: the combine adds partials on every paged call there.
* ``BWD_MUTATIONS`` edit the 16-bit route of ``csrc/flash_bwd.cu`` (the
  fused main pass and the post-pass that adds its dQ partials in a fixed
  order), ``LN_MUTATIONS`` the LayerNorm forward and backward of
  ``csrc/layernorm.cu`` (their rings of rows, the forward's variance, the
  backward's sums) and ``GELU_BWD_MUTATIONS`` the bias-GELU backward of
  ``csrc/bias_gelu.cu``: the row kernels and backwards that training runs.
  Each copy runs ``chip_smoke.bwd_hold``: one bf16 gradient step of
  full-width bert-large on a phase-2 batch (8 x 512 tokens: four KV tiles
  of 128 keys, so the flash backward's dQ partials are added; 4096
  LayerNorm rows, two a warp in the forward) with every call of each
  backward kernel and of the LayerNorm forward held against the plain
  version on its inputs, judged by ``chip_smoke.check_calls`` as
  chip_smoke.py judges it: elementwise TOL and relative L2
  ``CALL_REL_L2_BOUND``.

For the unchanged sources and for each mutation, this writes the source
under ``build/mutants/<name>/``, builds it, loads it in place of the real
library, runs the check and prints one JSON line: calls outside the
tolerance, the largest error, the relative L2 errors and which check fails.
Exits non-zero if an unchanged source fails a check or a mutation passes
all.  Needs a CUDA device; the mutated sources never leave the build
directory.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[3]

# name -> (text in the kernel body, its replacement)
MUTATIONS = {
    # one accumulator element of the second row rescaled by the first
    # row's correction factor: a fragment-layout slip
    "row1_fragment_rescale": ("o[4 * j + 2] *= c1;", "o[4 * j + 2] *= c0;"),
    # the causal diagonal masked out (an off-by-one in the mask)
    "diagonal_masked": ("keep = keep && ki <= qi;", "keep = keep && ki < qi;"),
    # the softmax scale 2 % too large
    "scale_2pct": ("const float sl2 = scale * kLog2e;",
                   "const float sl2 = scale * 1.02f * kLog2e;"),
}
PAGED_MUTATIONS = {
    # the first split's partial left out of the combine
    "split_partial_dropped": (
        "for (int s = 0; s < n_live; ++s) {  // in split order",
        "for (int s = 1; s < n_live; ++s) {  // in split order"),
    # the tail page's mask one token short: the newest token left out
    "tail_mask_off_by_one": ("s = tok < live ?", "s = tok < live - 1 ?"),
    # int8 pages' v_scale dropped from the page's probabilities
    "v_scale_dropped": ("p[g] *= vsc;", "p[g] *= 1.f;"),
}
BWD_MUTATIONS = {
    # dQ's softmax scale dropped in the post-pass
    "dq_scale_dropped": ("pack<T>(f[2 * i] * scale, f[2 * i + 1] * scale)",
                         "pack<T>(f[2 * i], f[2 * i + 1])"),
    # delta = rowsum(dO * O) read 2 % too large
    "delta_2pct": ("dl = dl_s[col];", "dl = dl_s[col] * 1.02f;"),
    # each KV tile's dQ partial stored over the sum, not added to it
    "dq_store_not_add": ("f[i] += s[i];", "f[i] = s[i];"),
    # the first live KV tile's dQ partial skipped by the post-pass
    "dq_partial_skipped": ("for (int t = lo; t < hi; ++t)",
                           "for (int t = lo + 1; t < hi; ++t)"),
}
LN_MUTATIONS = {
    # the forward reads the ring's next stage, not the row it waited for
    "fwd_ring_slot_off_by_one": ("ring + (k % stages) * rowb)",
                                 "ring + ((k + 1) % stages) * rowb)"),
    # the forward leaves each warp's last row out
    "fwd_warp_last_row_dropped": ("for (int k = 0; k < n; ++k) {",
                                  "for (int k = 0; k < n - 1; ++k) {"),
    # the variance summed from unsquared deviations
    "variance_unsquared": ("sq += dev * dev;", "sq += dev;"),
    # dscale summed as dy alone (dbias) instead of dy * xhat
    "dscale_as_dbias": ("ds[i][e] += gv[e] * h;", "ds[i][e] += gv[e];"),
    # the backward reads the ring's next stage, not the row it waited for
    "bwd_ring_slot_off_by_one": (
        "const unsigned char* st = ring + (k % stages) * stageb;",
        "const unsigned char* st = ring + ((k + 1) % stages) * stageb;"),
    # warp 1's dscale and dbias sums left out of the block's partial row
    "warp1_sums_dropped": ("for (int w = 1; w < BW; ++w) {",
                           "for (int w = 2; w < BW; ++w) {"),
}
GELU_BWD_MUTATIONS = {
    # the tanh term of GELU's derivative taken with the wrong sign
    "tanh_sign": ("0.5f * (1.f + t)", "0.5f * (1.f - t)"),
}
# source -> (the text that opens the code the mutations edit, the mutations)
SOURCES = {
    "flash_fwd": ("flash_fwd_hopper_kernel(const", MUTATIONS),
    "paged_decode": ("paged_decode_split_kernel(Args", PAGED_MUTATIONS),
    "flash_bwd": ("// 16-bit main pass at Dh 64: warpgroup", BWD_MUTATIONS),
    "layernorm": ("layernorm_kernel(const", LN_MUTATIONS),
    "bias_gelu": ("bias_gelu_bwd_kernel(const", GELU_BWD_MUTATIONS),
}
# the sources whose mutants the backward hold judges, and the kernels it
# holds: the backwards and the LayerNorm forward
BWD_SOURCES = ("flash_bwd", "layernorm", "bias_gelu")
BWD_HOLD = ("flash_attention_bwd", "layernorm_fwd", "layernorm_bwd",
            "bias_gelu_bwd")


def mutate(source: str, edit, body: str) -> str:
    """``source`` with ``edit`` = (old, new) applied once after ``body``
    (the start of the kernel code); raises if ``old`` is not found
    there."""
    if edit is None:
        return source
    old, new = edit
    at = source.index(body)
    tail = source[at:]
    if old not in tail:
        raise ValueError(f"mutation target {old!r} not in the kernel body")
    return source[:at] + tail.replace(old, new, 1)


def forward_check(smoke, T, serve_step, ops, cfg, params, pol) -> dict:
    res = smoke.path_parity(T, serve_step, ops, cfg, params, pol, "paged")
    k = "flash_attention"
    return {"flash_calls": res["calls"][k],
            "flash_calls_outside": res["calls_outside"][k],
            "flash_call_max_err": res["call_max_err"][k],
            "rel_l2": res["rel_l2"],
            "fails_per_call_check": res["calls_outside"][k] > 0,
            "fails_model_bound": res["rel_l2"] > smoke.LOGIT_REL_L2_BOUND[
                pol.compute_dtype]}


def paged_check(smoke, T, serve_step, ops, cfg, params, pol) -> dict:
    k, out, fails = "paged_decode_attention", {}, False
    for mode in ("paged", "paged_int8"):
        res = smoke.path_parity(T, serve_step, ops, cfg, params, pol, mode)
        try:
            smoke.check_parity(res)
        except AssertionError:
            fails = True
        out.update({f"{mode}_calls": res["calls"][k],
                    f"{mode}_calls_outside": res["calls_outside"][k],
                    f"{mode}_call_max_err": res["call_max_err"][k],
                    f"{mode}_call_max_rel_l2": res["call_max_rel"][k],
                    f"{mode}_rel_l2": res["rel_l2"]})
    return {**out, "fails_parity_check": fails}


def backward_check(smoke, ops, ts, cfg, state, batch, tcfg, pol) -> dict:
    res = smoke.bwd_hold(ops, ts, cfg, state, batch, tcfg, pol, BWD_HOLD)
    try:
        smoke.check_calls("phase-2 backward hold", res)
        fails = False
    except AssertionError:
        fails = True
    return {**{f"{k}_{field}": res[key][k] for k in BWD_HOLD
               for field, key in (("calls", "calls"),
                                  ("calls_outside", "calls_outside"),
                                  ("call_max_rel_l2", "call_max_rel"))},
            "fails_per_call_check": fails}


def run_family(build, name, check) -> list:
    """Each source of ``SOURCES[name]`` in turn; returns the names whose
    verdict is unexpected."""
    body, muts = SOURCES[name]
    source = (build.CSRC / f"{name}.cu").read_text()
    real_csrc, bad = build.CSRC, []
    try:
        for mname, edit in [("unchanged", None), *muts.items()]:
            where = build.BUILD_DIR.parent / "mutants" / mname
            where.mkdir(parents=True, exist_ok=True)
            (where / f"{name}.cu").write_text(mutate(source, edit, body))
            build.CSRC = where          # only this source is rebuilt from here
            build._LIBS.pop(name, None)
            res = check()
            print(json.dumps({"source": f"{name}:{mname}", **res}),
                  flush=True)
            caught = any(v for key, v in res.items()
                         if key.startswith("fails_"))
            if (edit is None) == caught:
                bad.append(mname)
    finally:
        build.CSRC = real_csrc
        build._LIBS.pop(name, None)
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mutation_check runs the kernels: no CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.amp import make_policy
    from repro_torch.kernels import build, ops
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    from repro_torch.serve import serve_step
    from repro_torch.train import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    print(smoke.nvidia_smi(), flush=True)
    build.build_all()
    for name in build.sources():
        build.load(name)
    pol = make_policy("bf16")

    cfg = get_config("deepseek-7b")
    params = T.init_model(cfg, seed=smoke.SEED, dtype=pol.param_dtype,
                          device="cuda")
    bad = run_family(build, "flash_fwd", lambda: forward_check(
        smoke, T, serve_step, ops, cfg, params, pol))
    bad += run_family(build, "paged_decode", lambda: paged_check(
        smoke, T, serve_step, ops, cfg, params, pol))
    del params
    torch.cuda.empty_cache()

    cfg = get_config("bert-large")
    inputs = smoke.bwd_hold_inputs(api, ts, TrainConfig, InputShape,
                                   make_policy, cfg)
    for name in BWD_SOURCES:
        bad += run_family(build, name, lambda: backward_check(
            smoke, ops, ts, cfg, *inputs))
    if bad:
        print(f"mutation_check: unexpected verdict for {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
