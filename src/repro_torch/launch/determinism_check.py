"""Is a BERT training run the same bits every time?  Runs the port's
training steps on the pipeline's batches several times from one seed and
compares the runs gradient group by gradient group, layer by layer.

  PYTHONPATH=src python -m repro_torch.launch.determinism_check \
      [--full-width] [--steps 4] [--runs 2] [--phase phase1|phase2] \
      [--precision bf16] [--impl torch] [--deterministic-algorithms] \
      [--device cuda]

Each run starts from a fresh state of ``--seed`` (the weights of
``launch/pretrain_bert.py``) and takes ``--steps`` steps of
``train_step_fn`` (accumulation 2, LAMB, the schedule of a 12-step phase)
on the batches that ``launch/pretrain_bert.py --batch 128`` feeds the
phase: the synthetic corpus sharded as it shards it, read by a
``ShardedLoader`` of the same seed.  Per step the loss and, for every
gradient group, one checksum per layer (the sum of the float32 words read
as integers) are kept; run 1's gradients are kept whole.  Every later
run reports its first step whose gradients differ from run 1's: each
(group, layer) that differs, with its count of differing elements, from
the last layer to the first (the order in which the backward computes
them), so the first entry names where the difference starts.  One JSON
line a run holds the loss bits, the checksums and a digest of each step's
checksums, so runs in two processes compare by their lines.  ``--impl torch`` runs the plain
versions instead of the kernels; ``--deterministic-algorithms`` runs under
``torch.use_deterministic_algorithms(True, warn_only=True)`` (set
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` for cuBLAS).  ``--probe-embedding
N`` only compares N backwards of each embedding table through
``F.embedding`` and through indexing (``probe_embedding``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import tempfile
import time

import torch
import torch.nn.functional as F

from repro_torch.configs import TrainConfig
from repro_torch.core.amp import make_policy
from repro_torch.data.pipeline import ShardedLoader, prepare_bert_data
from repro_torch.launch.pretrain_bert import model_config
from repro_torch.models import api
from repro_torch.train import train_step as ts
from repro_torch.train.phases import bert_phases


def _checksums(grads: dict, groups) -> dict:
    """{group name: [per-layer sum of the float32 words as int64]}."""
    out = {}
    for path, g in grads.items():
        words = g.view(max(groups.layers[path], 1), -1).view(torch.int32)
        out[".".join(path)] = words.to(torch.int64).sum(dim=1).tolist()
    return out


def _differences(got: dict, want: dict, groups) -> list:
    """(group, layer, differing elements) where ``got`` and ``want`` differ,
    the last layer first."""
    rows = []
    for path, g in got.items():
        n = max(groups.layers[path], 1)
        counts = (g != want[path]).view(n, -1).sum(dim=1).tolist()
        rows += [(".".join(path), layer, c)
                 for layer, c in enumerate(counts) if c]
    return sorted(rows, key=lambda r: (-r[1], r[0]))


def probe_embedding(batch: dict, d_model: int, vocab: int, n: int,
                    device) -> list:
    """The gradient of an embedding table, ``n`` times on one seeded
    output gradient, through ``F.embedding``, through indexing
    (``table[ids]``, whose backward is an accumulating ``index_put_``) and,
    for the 2-row segment table, through ``torch.where`` (a masked sum):
    how many of the ``n`` differ from the first in any bit, and the mean
    device ms of one backward (CUDA events around it; the host clock on
    the CPU).  For the segment table (``type_ids``) and the token table
    (``tokens``) of one micro-batch."""
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for name, ids, v in (("type", batch["type_ids"], 2),
                         ("tok", batch["tokens"], vocab)):
        ids = ids[: ids.shape[0] // 2]            # one micro-batch of two
        dy = torch.randn(*ids.shape, d_model, generator=gen, device=device)
        table = torch.randn(v, d_model, generator=gen, device=device,
                            requires_grad=True)
        forms = {"F.embedding": lambda t: F.embedding(ids, t),
                 "index": lambda t: t[ids]}
        if v == 2:
            forms["where"] = lambda t: torch.where(ids[..., None] == 1,
                                                   t[1], t[0])
        for form, fn in forms.items():
            out = fn(table)
            assert torch.equal(out, F.embedding(ids, table))
            grads, ms = [], []
            for _ in range(n + 1):                # the first is a warm-up
                if device == "cuda":
                    t0, t1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    t0.record()
                    grads.append(torch.autograd.grad(out, table, dy,
                                                     retain_graph=True)[0])
                    t1.record()
                    t1.synchronize()
                    ms.append(t0.elapsed_time(t1))
                else:
                    t0 = time.perf_counter()
                    grads.append(torch.autograd.grad(out, table, dy,
                                                     retain_graph=True)[0])
                    ms.append((time.perf_counter() - t0) * 1e3)
            grads, ms = grads[1:], ms[1:]
            differ = sum(not torch.equal(g, grads[0]) for g in grads[1:])
            rows.append({"table": name, "rows": v, "ids": ids.numel(),
                         "distinct_ids": int(ids.unique().numel()),
                         "form": form, "runs": n, "differ": differ,
                         "ms": sum(ms) / n, "min_ms": min(ms)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--full-depth", action="store_true")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--phase", default="phase1")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--impl", default=None)
    ap.add_argument("--deterministic-algorithms", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe-embedding", type=int, default=0, metavar="N",
                    help="only time and compare N embedding backwards")
    ap.set_defaults(layers=None)     # read by model_config
    args = ap.parse_args(argv)
    if args.deterministic_algorithms:
        torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = model_config(args)
    pol = make_policy(args.precision)
    phase = {p.name: p for p in bert_phases(
        13, scale_batch=args.batch / 4096)}[args.phase]
    tcfg = TrainConfig(precision=args.precision, accum_steps=2,
                       optimizer="lamb",
                       learning_rate=phase.learning_rate * 20,
                       total_steps=12, warmup_steps=2)
    with tempfile.TemporaryDirectory(prefix="determinism_") as tmp:
        prepare_bert_data(tmp, seq_len=phase.seq_len,
                          n_predictions=phase.n_predictions, n_docs=120,
                          vocab_size=cfg.vocab_size, n_shards=4,
                          seed=args.seed)
        loader = ShardedLoader(tmp, worker=0, n_workers=1,
                               batch=phase.global_batch, seed=args.seed)
        batches = [api.to_device(next(loader), args.device)
                   for _ in range(args.steps)]
    print(json.dumps({"device": (torch.cuda.get_device_name(0)
                                 if args.device == "cuda" else "cpu"),
                      "phase": args.phase, "n_layers": cfg.n_layers,
                      "d_model": cfg.d_model, "precision": args.precision,
                      "impl": args.impl, "batch": phase.global_batch,
                      "deterministic_algorithms":
                          args.deterministic_algorithms}), flush=True)
    if args.probe_embedding:
        for row in probe_embedding(batches[0], cfg.d_model, cfg.vocab_size,
                                   args.probe_embedding, args.device):
            print(json.dumps(row), flush=True)
        return
    seen = []
    real = ts.step_gradients

    def keep_gradients(*a, **kw):
        loss, grads, metrics = real(*a, **kw)
        seen.append({p: g.clone() for p, g in grads.items()})
        return loss, grads, metrics

    ts.step_gradients = keep_gradients
    kept = []       # run 1's gradients, a dict a step
    try:
        for run in range(1, args.runs + 1):
            params = api.init_params(cfg, seed=args.seed,
                                     device=args.device)
            state = ts.init_train_state(params, pol, tcfg, cfg=cfg)
            del params
            groups = state.opt.groups
            losses, sums, report = [], [], None
            for step, batch in enumerate(batches, 1):
                state, m = ts.train_step_fn(state, batch, cfg=cfg,
                                            tcfg=tcfg, policy=pol,
                                            impl=args.impl)
                losses.append(float(m["loss"]).hex())
                grads = seen.pop()
                sums.append(_checksums(grads, groups))
                if run == 1:
                    kept.append(grads)
                elif report is None:
                    diff = _differences(grads, kept[step - 1], groups)
                    if diff:
                        report = {"first_step": step,
                                  "groups_layers": len(diff),
                                  "first_differences": diff[:12]}
            digests = [hashlib.sha256(json.dumps(c, sort_keys=True).encode())
                       .hexdigest()[:16] for c in sums]
            print(json.dumps({"run": run, "losses": losses,
                              "gradient_digests": digests,
                              "differs_from_run_1": report,
                              "checksums": sums}), flush=True)
            del state
    finally:
        ts.step_gradients = real


if __name__ == "__main__":
    main()
