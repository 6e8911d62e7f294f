"""Supervised training loop: step function x data stream x checkpoints
(port of ``repro/train/trainer.py``).

Beyond the plain drive-the-step loop, this is the fault-tolerance layer
the 12-day-commodity-cluster setting demands (and ``train/faults.py``
injects against):

* **Exact resume.**  ``resume=True`` restores the newest *valid*
  checkpoint (corrupt/torn ones are skipped with a warning inside
  ``restore_checkpoint`` -- never a silent restart from step 0; only a
  genuinely empty checkpoint dir starts fresh, with an info log).  The
  manifest's ``extra`` carries the data-loader cursor: if ``batches``
  exposes ``state_dict()``/``load_state_dict()`` (``ShardedLoader``)
  the sample stream continues exactly where the crashed run left it, so a
  resumed loss trajectory is bit-identical to an uninterrupted one.
* **Non-finite supervision.**  Steps reporting a non-finite loss (or the
  AMP ``skipped`` flag from core/amp.py's dynamic loss scale -- this loop
  *observes* that machinery, it does not duplicate it) are counted;
  ``max_consecutive_skips`` bounds how many may occur back-to-back before
  the run aborts with an emergency checkpoint instead of burning days on
  a diverged model.  Counts surface as ``consecutive_skips``/
  ``total_skips`` metrics.
* **Step watchdog.**  An EMA of step duration flags hangs/stragglers:
  steps slower than ``watchdog_factor`` x the EMA log a warning and count
  into the ``slow_steps`` metric.
* **Bounded retry.**  Transient step failures (``TransientStepError``,
  ``RuntimeError``; under data parallelism ``TransientStepError`` alone,
  see below) are retried up to ``max_retries`` times with linear
  backoff before giving up.  A retry re-runs the same step function (the
  same kernels); nothing switches to the plain versions.  The port's step
  updates its state in place, all at once after its last operation that
  can fail (``train/train_step.py``), so a step that raised left the state
  as it was, for the retry and for the emergency checkpoint alike.
* **Emergency checkpoint.**  Any exception escaping the loop triggers a
  best-effort ``save_checkpoint`` at the last completed step before
  re-raising (hard crashes -- ``os._exit`` -- by design get nothing;
  that is what the atomic checkpoint + resume path is for).

Metrics may be tensors (on any device), bools or floats: the loop reads
them with ``float``.

Data parallelism (``mesh``, a ``launch.mesh.DPMesh`` of world > 1; the
reference's loop is one process, so it has no such argument).  Every rank
runs this loop on the same global batches and the step exchanges the
gradients (``train/train_step.py`` ``make_train_step_dp``).  The ranks
share one filesystem: ``ckpt_dir`` names the same directory on every
rank.

* rank 0 alone writes checkpoints, the emergency checkpoint too, and every
  rank waits at a barrier after each regular save, so no rank runs ahead
  of a checkpoint that may not exist yet.  With the compressed exchange
  the state holds a residual per rank (``TrainState.err``), and a
  checkpoint must hold every rank's row: before each regular save every
  rank joins a gather of the rows to rank 0 (``gather_residual``).  On
  ``resume`` every rank restores the newest checkpoint it finds (its own
  residual row), then the ranks compare the step and the manifest's
  checksums they restored and raise unless all agree (ranks that do not
  share the directory would otherwise start from different states and
  exchange gradients of different steps).  The loader cursor is then the
  same on every rank, since every rank reads the same global loader;
* the supervision reads only reduced values (the loss, the skip flag of
  the reduced gradients), so every rank counts the same skips and aborts
  at the same step, and ``REPRO_FAULTS`` fires on every rank at the same
  step (each rank reads the same environment);
* only ``TransientStepError`` is retried, which ``REPRO_FAULTS`` raises
  on every rank at the same step, before the step's collectives.  Any
  other error (a ``RuntimeError`` of one rank, a failed collective) ends
  the run with the emergency checkpoint: a retry on one rank alone would
  pair its collectives with its peers' next step, whose all-reduces have
  the same shapes and order, and the ranks would go on from states one
  step apart with nothing to show it.  The peers of a rank that ended
  fail in their next collective (at once when its process is gone, at
  the process group's timeout otherwise).  Not covered, so: a transient
  error of one rank alone is not retried; the run ends, and ``resume``
  takes it up from its last checkpoint;
* the emergency checkpoint of a state with a residual needs every rank's
  row, so a gather every rank must join.  Every rank reaches the
  emergency path at the same step only for ``NonFiniteBudgetError`` and
  for ``TransientStepError`` whose retries ran out (the supervision reads
  reduced values alone, and ``REPRO_FAULTS`` fires on every rank): those
  gather and save.  For any other error at world > 1 with a residual no
  emergency checkpoint is written, and a warning names the last regular
  one: a checkpoint with a rank's residual missing, zeroed or stale is
  never written.
* A checkpoint whose leaves are not the state's (a residual group where
  the run has none or the other way round, another world) raises
  ``ValueError`` on ``resume`` instead of starting fresh over it.
"""
from __future__ import annotations

import logging
import math
import time
from typing import Callable, Iterator, Optional

from repro_torch.core.amp import LossScaleState, loss_scale_summary
from repro_torch.train.checkpoint import (load_manifest, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.faults import FaultInjector, TransientStepError
from repro_torch.train.train_step import ResidualRows, gather_residual

logger = logging.getLogger("repro_torch.train")


class NonFiniteBudgetError(RuntimeError):
    """Too many consecutive non-finite (skipped) steps: run aborted."""


def _checkpoint_extra(batches, state, *, fingerprint: Optional[str],
                      seed: Optional[int]) -> dict:
    extra: dict = {"wall_time": time.time()}
    if fingerprint is not None:
        extra["fingerprint"] = fingerprint
    if seed is not None:
        extra["seed"] = seed
    if hasattr(batches, "state_dict"):
        extra["data_state"] = batches.state_dict()
    ls = getattr(state, "loss_scale", None)
    if isinstance(ls, LossScaleState):
        extra["loss_scale"] = loss_scale_summary(ls)
    return extra


def _resume(state, batches, ckpt_dir: str, fingerprint: Optional[str]):
    """Restore (state, start_step), reloading the data cursor if possible."""
    try:
        state, start = restore_checkpoint(ckpt_dir, state)
    except FileNotFoundError as e:
        if isinstance(e.__cause__, ValueError):
            # a valid checkpoint of another state: starting fresh would
            # write over the run it belongs to
            raise ValueError(f"cannot resume from {ckpt_dir}: "
                             f"{e.__cause__}") from e
        logger.info("no checkpoint in %s: starting fresh from step 0",
                    ckpt_dir)
        return state, 0
    logger.info("resumed from checkpoint step %d in %s", start, ckpt_dir)
    manifest = load_manifest(ckpt_dir, start) or {}
    extra = manifest.get("extra", {})
    if fingerprint is not None and "fingerprint" in extra and \
            extra["fingerprint"] != fingerprint:
        logger.warning(
            "checkpoint config fingerprint %r != current %r -- resuming "
            "anyway, but the runs are not comparable",
            extra["fingerprint"], fingerprint)
    data_state = extra.get("data_state")
    if data_state is not None and hasattr(batches, "load_state_dict"):
        batches.load_state_dict(data_state)
        logger.info("data stream cursor restored: %s", data_state)
    elif hasattr(batches, "load_state_dict"):
        logger.warning(
            "checkpoint carries no data cursor: the resumed run will "
            "replay the stream from its current position (sample order "
            "will differ from the uninterrupted run)")
    return state, start


def _check_same_resume(mesh, ckpt_dir: str, start: int) -> None:
    """Raise unless every rank restored the same checkpoint: the same step
    and the same per-leaf checksums (none for a fresh start)."""
    manifest = load_manifest(ckpt_dir, start) if start else None
    mine = (start, (manifest or {}).get("checksums"))
    ranks = mesh.gather_objects(mine)
    if any(r != ranks[0] for r in ranks):
        raise RuntimeError(
            "data-parallel ranks resumed from different checkpoints (steps "
            f"{[r[0] for r in ranks]} in {ckpt_dir!r}): every rank must "
            "read rank 0's checkpoint directory on one shared filesystem")


def train_loop(step_fn: Callable, state, batches: Iterator, *,
               total_steps: int, log_every: int = 10,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 500,
               resume: bool = False, tokens_per_step: Optional[int] = None,
               metrics_hook: Optional[Callable] = None,
               keep: int = 3,
               max_consecutive_skips: Optional[int] = 25,
               max_retries: int = 2, retry_backoff_s: float = 0.05,
               watchdog_factor: float = 10.0,
               faults: Optional[FaultInjector] = None,
               config_fingerprint: Optional[str] = None,
               seed: Optional[int] = None,
               timing_calib: Optional[dict] = None,
               mesh=None):
    """Returns (final_state, history list of metric dicts).

    ``batches`` may be a plain iterator; if it also implements
    ``state_dict``/``load_state_dict`` its cursor is checkpointed and
    restored for exact resume.  ``faults`` defaults to an injector built
    from the ``REPRO_FAULTS`` env var (no-op when unset).

    ``timing_calib``: optional ``{"compute_s": float, "serial_step_s":
    float}`` calibration (``launch/pretrain_bert.py --timing-breakdown``
    times a no-exchange twin and a serial-schedule twin of its
    data-parallel step at the start of each phase, as the reference's
    ``launch/train.py`` does once).  When present, every logged window
    also reports ``compute_s`` / ``exchange_s`` (mean step time split
    against the compute twin) and ``overlap_frac`` (the fraction of the
    serial schedule's exchange time this run hides; not reported when the
    serial twin shows no exchange time to hide), so overlap wins are
    observable per-run, not inferred from benchmarks.

    ``mesh``: the data-parallel ranks (see the module docstring), or None
    for one process.
    """
    faults = faults if faults is not None else FaultInjector()
    writer = mesh is None or mesh.rank == 0

    gather = getattr(state, "err", None) is not None and mesh is not None \
        and mesh.world > 1

    def _save(step_no, **extra):
        tree = state
        if gather:   # every rank joins; rank 0 gets every rank's row
            tree = ResidualRows(state, gather_residual(state, mesh))
        path = None
        if writer:
            path = save_checkpoint(ckpt_dir, step_no, tree, keep=keep,
                                   extra=dict(_extra(), **extra))
        return path
    start = 0
    if resume and ckpt_dir:
        state, start = _resume(state, batches, ckpt_dir, config_fingerprint)
        if mesh is not None and mesh.world > 1:
            _check_same_resume(mesh, ckpt_dir, start)
    # one rank's retry would put its collectives out of step with its peers'
    retryable = (TransientStepError,) if mesh is not None and \
        mesh.world > 1 else (TransientStepError, RuntimeError)

    def _extra():
        return _checkpoint_extra(batches, state,
                                 fingerprint=config_fingerprint, seed=seed)

    history = []
    last_saved = start or None     # the newest checkpoint this run has
    consecutive_skips = total_skips = slow_steps = retries_used = 0
    step = start
    ema_dt: Optional[float] = None
    try:
        t0 = time.time()
        window_t0, window_steps = t0, 0
        window_step_s, window_timed = 0.0, 0
        for step in range(start, total_steps):
            batch = next(batches)
            t_step = time.perf_counter()
            faults.maybe_slow(step + 1)  # inside the watchdog's timed window
            if faults.maybe_nan(step + 1):
                # forged non-finite step: state kept, update skipped --
                # the runtime-level mirror of the AMP skip path
                metrics = {"loss": float("nan"), "skipped": True}
            else:
                for attempt in range(max_retries + 1):
                    try:
                        faults.maybe_fail(step + 1)
                        state, metrics = step_fn(state, batch)
                        break
                    except retryable as e:
                        if attempt >= max_retries:
                            raise
                        retries_used += 1
                        logger.warning(
                            "step %d attempt %d failed (%s): retrying in "
                            "%.2fs", step + 1, attempt + 1, e,
                            retry_backoff_s * (attempt + 1))
                        time.sleep(retry_backoff_s * (attempt + 1))
            dt = time.perf_counter() - t_step
            window_steps += 1
            if step - start >= 1:  # exclude the compile-bearing first step
                window_step_s += dt
                window_timed += 1

            # --- non-finite supervision (observes the AMP skip flag) ---
            if max_consecutive_skips is not None:
                loss_val = float(metrics.get("loss", 0.0))
                skipped = bool(metrics.get("skipped", False)) \
                    or not math.isfinite(loss_val)
                if skipped:
                    consecutive_skips += 1
                    total_skips += 1
                    if consecutive_skips > max_consecutive_skips:
                        raise NonFiniteBudgetError(
                            f"{consecutive_skips} consecutive non-finite/"
                            f"skipped steps at step {step + 1} (budget "
                            f"{max_consecutive_skips}): aborting")
                else:
                    consecutive_skips = 0

            # --- step-duration watchdog (EMA baseline; the compile-bearing
            # first step is excluded from the baseline) ---
            if step - start >= 1:
                if ema_dt is not None and dt > watchdog_factor * ema_dt:
                    slow_steps += 1
                    logger.warning(
                        "watchdog: step %d took %.3fs (> %.0fx the %.3fs "
                        "EMA) -- straggler or hang?", step + 1, dt,
                        watchdog_factor, ema_dt)
                else:
                    # slow outliers are excluded from the baseline so one
                    # straggler does not mask the next
                    ema_dt = dt if ema_dt is None else \
                        0.9 * ema_dt + 0.1 * dt

            if (step + 1) % log_every == 0 or step + 1 == total_steps:
                metrics = {k: float(v) for k, v in metrics.items()}
                wdt = time.time() - window_t0
                metrics["steps_per_s"] = window_steps / max(wdt, 1e-9)
                if tokens_per_step:
                    metrics["tokens_per_s"] = metrics["steps_per_s"] * \
                        tokens_per_step
                metrics["step"] = step + 1
                metrics["consecutive_skips"] = consecutive_skips
                metrics["total_skips"] = total_skips
                metrics["slow_steps"] = slow_steps
                metrics["retries"] = retries_used
                timing_str = ""
                if timing_calib and window_timed:
                    mean_dt = window_step_s / window_timed
                    compute_s = float(timing_calib["compute_s"])
                    exchange_s = max(0.0, mean_dt - compute_s)
                    metrics["compute_s"] = compute_s
                    metrics["exchange_s"] = exchange_s
                    timing_str = (f"cmp {compute_s * 1e3:.1f}ms | "
                                  f"xch {exchange_s * 1e3:.1f}ms | ")
                    serial_s = timing_calib.get("serial_step_s")
                    if serial_s is not None:
                        serial_xch = max(0.0, float(serial_s) - compute_s)
                        if serial_xch > 0:
                            ovl = 1.0 - exchange_s / serial_xch
                            metrics["overlap_frac"] = max(0.0, min(1.0, ovl))
                            timing_str += \
                                f"ovl {metrics['overlap_frac']:.2f} | "
                history.append(metrics)
                logger.info(
                    "step %d | loss %.4f | %s%s%.1f steps/s",
                    step + 1, metrics.get("loss", float("nan")),
                    (f"{metrics['tokens_per_s']:.0f} tok/s | "
                     if "tokens_per_s" in metrics else ""),
                    timing_str,
                    metrics["steps_per_s"])
                if metrics_hook:
                    metrics_hook(metrics)
                window_t0, window_steps = time.time(), 0
                window_step_s, window_timed = 0.0, 0
            faults.maybe_crash(step + 1)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                path = _save(step + 1)
                last_saved = step + 1
                if path is not None:
                    faults.maybe_torn_write(step + 1, path)
                if mesh is not None:
                    mesh.barrier()
    except Exception as e:
        everywhere = isinstance(e, (NonFiniteBudgetError,
                                    TransientStepError))
        if ckpt_dir and gather and not everywhere:
            if writer:
                logger.warning(
                    "no emergency checkpoint: %s may have ended this rank "
                    "alone, and the residuals of the other ranks cannot be "
                    "gathered; the last regular checkpoint in %s is step "
                    "%s", type(e).__name__, ckpt_dir,
                    "none" if last_saved is None else last_saved)
        elif ckpt_dir and (writer or gather):
            done = step if step < total_steps else total_steps
            try:
                _save(done, emergency=True)
                if writer:
                    logger.warning("emergency checkpoint saved at step %d "
                                   "in %s", done, ckpt_dir)
            except Exception as ce:  # noqa: BLE001 -- best effort only
                logger.warning("emergency checkpoint failed: %s", ce)
        raise
    if ckpt_dir and start < total_steps:
        _save(total_steps)
        if mesh is not None:
            mesh.barrier()
    return state, history
