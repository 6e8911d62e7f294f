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
  ``RuntimeError``) are retried up to ``max_retries`` times with linear
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
    except FileNotFoundError:
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
               timing_calib: Optional[dict] = None):
    """Returns (final_state, history list of metric dicts).

    ``batches`` may be a plain iterator; if it also implements
    ``state_dict``/``load_state_dict`` its cursor is checkpointed and
    restored for exact resume.  ``faults`` defaults to an injector built
    from the ``REPRO_FAULTS`` env var (no-op when unset).

    ``timing_calib``: optional ``{"compute_s": float, "serial_step_s":
    float}`` calibration (the reference's ``launch/train.py`` times a
    no-exchange twin and a serial-schedule twin of its data-parallel step
    once at startup; the port's exchange comes with the data-parallel
    slice, and no caller passes it yet).  When present, every logged
    window also reports ``compute_s`` / ``exchange_s`` (mean step time
    split against the compute twin) and ``overlap_frac`` (the fraction of
    the serial schedule's exchange time this run hides), so overlap wins
    are observable per-run, not inferred from benchmarks.
    """
    faults = faults if faults is not None else FaultInjector()
    start = 0
    if resume and ckpt_dir:
        state, start = _resume(state, batches, ckpt_dir, config_fingerprint)

    def _extra():
        return _checkpoint_extra(batches, state,
                                 fingerprint=config_fingerprint, seed=seed)

    history = []
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
                    except (TransientStepError, RuntimeError) as e:
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
                path = save_checkpoint(ckpt_dir, step + 1, state, keep=keep,
                                       extra=_extra())
                faults.maybe_torn_write(step + 1, path)
    except Exception:
        if ckpt_dir:
            done = step if step < total_steps else total_steps
            try:
                save_checkpoint(ckpt_dir, done, state, keep=keep,
                                extra=dict(_extra(), emergency=True))
                logger.warning("emergency checkpoint saved at step %d in %s",
                               done, ckpt_dir)
            except Exception as ce:  # noqa: BLE001 -- best effort only
                logger.warning("emergency checkpoint failed: %s", ce)
        raise
    if ckpt_dir and start < total_steps:
        save_checkpoint(ckpt_dir, total_steps, state, keep=keep,
                        extra=_extra())
    return state, history
