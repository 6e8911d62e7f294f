"""Deterministic fault injection for the training runtime (port of
``repro/train/faults.py``).

Long pretraining runs on commodity/preemptible hardware (the source
paper's 12-day academic-cluster setting) die in predictable ways: hard
node crashes, checkpoint writes torn mid-flight, NaN gradients from an
overflowing loss scale, and straggler/hung steps.  This module turns each
of those into a *deterministic, step-indexed* injection point so the
trainer's recovery machinery (``train/trainer.py``) can be exercised:

* ``crash_at``   -- hard ``os._exit(crash_code)`` after step N completes
                    (before that step's checkpoint is written): the
                    process dies like a preempted node, nothing is
                    flushed, no ``finally`` blocks run.
* ``torn_at``    -- after the checkpoint at step N is committed, its
                    ``.npz`` is truncated to ``torn_bytes`` bytes,
                    simulating a torn write / disk corruption that the
                    restore path must detect and fall back across.
* ``nan_at``     -- ``nan_count`` consecutive steps starting at N are
                    forged as non-finite: the step is skipped (state kept,
                    like the AMP loss-scale skip path) and the trainer's
                    consecutive-skip budget sees it.
* ``fail_at``    -- ``fail_count`` consecutive attempts of step N raise
                    ``TransientStepError`` before the step function runs,
                    exercising the bounded retry-with-backoff path.
* ``slow_at``    -- step N sleeps ``slow_s`` seconds before running, so
                    the step-duration watchdog flags it.

The plan is config- or env-driven: ``FaultPlan.from_env()`` parses
``REPRO_FAULTS="crash_at=6,torn_at=3,torn_bytes=128"`` so subprocess
tests and ``chip_smoke.py`` can inject faults into an unmodified
``python -m repro_torch.launch.pretrain_bert`` invocation.  Steps are
1-based "completed steps" of one ``train_loop`` call, matching checkpoint
step numbering (the BERT launcher calls it once per phase, so a plan
fires in every phase long enough to reach its step).  ``REPRO_FAULTS``
only injects faults: nothing in it selects a device, a kernel or the
plain versions.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import logging
import time
from pathlib import Path
from typing import Optional

logger = logging.getLogger("repro_torch.train")

ENV_VAR = "REPRO_FAULTS"


class TransientStepError(RuntimeError):
    """An injected (or genuinely transient) step failure worth retrying."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Step-indexed fault schedule (all steps 1-based; None = never)."""
    crash_at: Optional[int] = None
    crash_code: int = 43          # distinctive exit code CI asserts on
    torn_at: Optional[int] = None
    torn_bytes: int = 64          # bytes the torn .npz is truncated to
    nan_at: Optional[int] = None
    nan_count: int = 1
    fail_at: Optional[int] = None
    fail_count: int = 1
    slow_at: Optional[int] = None
    slow_s: float = 0.0

    @classmethod
    def from_env(cls, env=None) -> "FaultPlan":
        """Parse ``REPRO_FAULTS="k=v,k=v"`` (unset/empty => no faults)."""
        spec = (env if env is not None else os.environ).get(ENV_VAR, "")
        kw = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in [f.name for f in dataclasses.fields(cls)]:
                raise ValueError(f"{ENV_VAR}: unknown fault key {k!r}")
            kw[k] = float(v) if k == "slow_s" else int(v)
        return cls(**kw)

    @property
    def any(self) -> bool:
        return any(getattr(self, f) is not None
                   for f in ("crash_at", "torn_at", "nan_at", "fail_at",
                             "slow_at"))


def torn_write(path, keep_bytes: int = 64) -> None:
    """Truncate ``path`` to ``keep_bytes`` bytes -- a torn/partial write.

    Also usable directly by tests to corrupt an existing checkpoint.
    """
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(min(keep_bytes, size))


class FaultInjector:
    """Stateful executor of a ``FaultPlan``; the trainer calls the
    ``maybe_*`` hooks at its injection points.  With an empty plan every
    hook is a cheap no-op, so the injector is always wired in."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan if plan is not None else FaultPlan.from_env()
        self._nan_left = self.plan.nan_count
        self._fail_left = self.plan.fail_count

    def maybe_slow(self, step: int) -> bool:
        """Sleep before step ``step`` (1-based) if scheduled."""
        if self.plan.slow_at == step and self.plan.slow_s > 0:
            logger.warning("[faults] injecting %.2fs slow step at %d",
                           self.plan.slow_s, step)
            time.sleep(self.plan.slow_s)
            return True
        return False

    def maybe_fail(self, step: int) -> None:
        """Raise ``TransientStepError`` for the first ``fail_count``
        attempts of step ``step`` (the retry loop then succeeds)."""
        if self.plan.fail_at == step and self._fail_left > 0:
            self._fail_left -= 1
            raise TransientStepError(
                f"[faults] injected transient failure at step {step} "
                f"({self._fail_left} more)")

    def maybe_nan(self, step: int) -> bool:
        """True => forge step ``step`` as a non-finite (skipped) step."""
        if self.plan.nan_at is not None and \
                self.plan.nan_at <= step < self.plan.nan_at + \
                self.plan.nan_count and self._nan_left > 0:
            self._nan_left -= 1
            logger.warning("[faults] injecting non-finite step at %d", step)
            return True
        return False

    def maybe_torn_write(self, step: int, npz_path) -> bool:
        """After the checkpoint at ``step`` was committed, tear its
        payload (the manifest stays -- exactly what validation catches)."""
        if self.plan.torn_at == step and npz_path is not None:
            logger.warning("[faults] tearing checkpoint %s to %d bytes",
                           npz_path, self.plan.torn_bytes)
            torn_write(Path(npz_path), self.plan.torn_bytes)
            return True
        return False

    def maybe_crash(self, step: int) -> None:
        """Hard-exit after step ``step`` completed -- no cleanup, no
        emergency checkpoint: a preempted node, not a polite shutdown."""
        if self.plan.crash_at == step:
            logger.error("[faults] hard crash injected after step %d "
                         "(exit %d)", step, self.plan.crash_code)
            sys.stderr.flush()
            sys.stdout.flush()
            os._exit(self.plan.crash_code)
