"""Would ``chip_smoke.py``'s path-parity check see a subtly wrong flash
kernel?

  PYTHONPATH=src python -m repro_torch.launch.mutation_check

Serving runs the bf16 tensor-core body of ``csrc/flash_fwd.cu``
(``flash_fwd_mma_kernel``).  For the unchanged source and for each mutation
in ``MUTATIONS`` (one small edit in that body), this writes the source under
``build/mutants/<name>/``, builds it, loads it in place of the real flash
library, and runs ``chip_smoke.path_parity`` on full-width deepseek-7b in
bf16 with a paged cache: one request's prefill and 4 decode steps through
the kernels and through the plain versions.  Per source it prints one JSON
line: how many flash calls fell outside the bf16 tolerance against the plain
version on the same inputs, the largest such error, the model-level rel L2
of the logits, and which of the two checks fails.  Exits non-zero if the
unchanged source fails a check or a mutation passes both.  Needs a CUDA
device; the mutated sources never leave the build directory.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[3]

# name -> (text in the tensor-core body, its replacement)
MUTATIONS = {
    # one accumulator element of the second row rescaled by the first
    # row's correction factor: a fragment-layout slip
    "row1_fragment_rescale": ("o[n][2] *= c1;", "o[n][2] *= c0;"),
    # the causal diagonal masked out (an off-by-one in the mask)
    "diagonal_masked": ("keep = keep && ki <= qi;", "keep = keep && ki < qi;"),
    # the softmax scale 2 % too large
    "scale_2pct": ("float x = s[n][e] * scale;",
                   "float x = s[n][e] * (scale * 1.02f);"),
}
_BODY = "flash_fwd_mma_kernel(const"


def mutate(source: str, edit) -> str:
    """``source`` with ``edit`` = (old, new) applied once inside the
    tensor-core kernel's body; raises if ``old`` is not found there."""
    if edit is None:
        return source
    old, new = edit
    at = source.index(_BODY)
    body = source[at:]
    if old not in body:
        raise ValueError(f"mutation target {old!r} not in the kernel body")
    return source[:at] + body.replace(old, new, 1)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mutation_check runs the kernels: no CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.core.amp import make_policy
    from repro_torch.kernels import build, ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import serve_step

    torch.backends.cuda.matmul.allow_tf32 = False
    print(smoke.nvidia_smi(), flush=True)
    build.build_all()
    build.load("paged_decode")
    cfg = get_config("deepseek-7b")
    pol = make_policy("bf16")
    params = T.init_model(cfg, seed=smoke.SEED, dtype=pol.param_dtype,
                          device="cuda")
    source = (build.CSRC / "flash_fwd.cu").read_text()
    real_csrc, bad = build.CSRC, []
    try:
        for name, edit in [("unchanged", None), *MUTATIONS.items()]:
            where = build.BUILD_DIR.parent / "mutants" / name
            where.mkdir(parents=True, exist_ok=True)
            (where / "flash_fwd.cu").write_text(mutate(source, edit))
            build.CSRC = where          # only flash_fwd is rebuilt from here
            build._LIBS.pop("flash_fwd", None)
            res = smoke.path_parity(T, serve_step, ops, cfg, params, pol,
                                    "paged")
            k = "flash_attention"
            by_calls = res["calls_outside"][k] > 0
            by_model = res["rel_l2"] > smoke.LOGIT_REL_L2_BOUND[pol.compute_dtype]
            print(json.dumps({
                "source": name, "flash_calls": res["calls"][k],
                "flash_calls_outside": res["calls_outside"][k],
                "flash_call_max_err": res["call_max_err"][k],
                "rel_l2": res["rel_l2"], "fails_per_call_check": by_calls,
                "fails_model_bound": by_model}), flush=True)
            if (edit is None) == (by_calls or by_model):
                bad.append(name)
    finally:
        build.CSRC = real_csrc
        build._LIBS.pop("flash_fwd", None)
    if bad:
        print(f"mutation_check: unexpected verdict for {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
