"""Fault tolerance: preemption-triggered checkpoints and a step watchdog.

Counterpart of ``repro/runtime/ft.py``, the port's own copy. The failure
model of a long training run and the mechanisms here:

(a) planned preemption (SIGTERM with a grace window): ``PreemptionGuard``
    installs SIGTERM / SIGINT handlers that set a flag the training loop
    polls each step; the loop then checkpoints and exits 0, so a scheduler
    treats it as a clean preemption.
(b) hard loss of the process: the run restarts from the latest complete
    checkpoint (``repro_torch.checkpoint.store.latest_step`` + restore)
    and the stateless data pipeline resumes exactly from the step counter.
(c) stragglers: ``StepWatchdog`` records per-step wall times and flags a
    step slower than ``threshold_x`` times the trailing median, so the
    launcher can report it.
"""
from __future__ import annotations

import signal
import statistics
import time
from dataclasses import dataclass, field


class PreemptionGuard:
    """Context manager: while inside, SIGTERM and SIGINT set
    ``requested`` instead of ending the process; the previous handlers
    come back on exit."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False


@dataclass
class StepWatchdog:
    threshold_x: float = 2.0
    window: int = 50
    times: list = field(default_factory=list)
    slow_steps: list = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        """Returns True if this step was a straggler outlier (from the
        10th step on, against the median of the last ``window``)."""
        dt = time.monotonic() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 10:
            med = statistics.median(self.times)
            if dt > self.threshold_x * med:
                self.slow_steps.append((step, dt, med))
                return True
        return False

    @property
    def median(self):
        return statistics.median(self.times) if self.times else 0.0
