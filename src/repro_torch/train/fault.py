"""Fault tolerance & straggler mitigation for the training driver: the
policies of ``repro.train.fault``, unchanged.

On a fleet the failure signals are device errors, host heartbeats and
preemption notices; in one process they surface as exceptions from the
step.  The policy layer is hardware-independent:

* ``RetryPolicy``  — a step that raises is retried after restoring the last
  checkpoint (``on_failure``); repeated failures back off and finally
  re-raise, at which point an external supervisor would reschedule the job.
* ``StragglerDetector`` — EWMA of step wall-time; a step exceeding
  ``k x EWMA`` is flagged and logged.
"""

from __future__ import annotations

import dataclasses
import logging
import time

log = logging.getLogger("repro_torch.fault")


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.1      # EWMA coefficient
    threshold: float = 3.0  # k x EWMA -> straggler
    warmup_steps: int = 5   # compile-time steps excluded
    _ewma: float = 0.0
    _seen: int = 0

    def observe(self, dt: float) -> bool:
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return False
        if self._ewma == 0.0:
            self._ewma = dt
            return False
        is_straggler = dt > self.threshold * self._ewma
        self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        if is_straggler:
            log.warning(
                "straggler step: %.3fs vs EWMA %.3fs (>%.1fx)",
                dt, self._ewma, self.threshold,
            )
        return is_straggler


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 3
    backoff_s: float = 1.0

    def run(self, fn, on_failure=None):
        """Run fn(); on exception call on_failure(attempt, exc) (restore
        hook) and retry with exponential backoff."""
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except Exception as exc:  # noqa: BLE001 — deliberate catch-all
                if attempt == self.max_retries:
                    raise
                log.error("step failed (%s); retry %d/%d",
                          exc, attempt + 1, self.max_retries)
                if on_failure is not None:
                    on_failure(attempt, exc)
                time.sleep(self.backoff_s * (2 ** attempt))
        raise RuntimeError("unreachable")
