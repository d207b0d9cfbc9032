"""Fault tolerance (``repro_torch.runtime.ft``): SIGTERM sets the guard
instead of ending the process, the handlers come back on exit, and the
watchdog flags a step far slower than the trailing median."""
import os
import signal
import time

from repro_torch.runtime import ft
from repro_torch.runtime.ft import PreemptionGuard, StepWatchdog


def test_sigterm_sets_the_guard_and_handlers_come_back():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):        # delivered at the next bytecode
            if guard.requested:
                break
            time.sleep(0.001)
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) is before


def test_sigint_sets_the_guard():
    with PreemptionGuard() as guard:
        os.kill(os.getpid(), signal.SIGINT)
        for _ in range(100):
            if guard.requested:
                break
            time.sleep(0.001)
        assert guard.requested


def test_watchdog_flags_an_outlier(monkeypatch):
    """Steps of 0.125 s, then one of 0.5 s (4x the median): flagged; the
    times are exact binary fractions on a fake clock."""
    clock = [0.0]
    monkeypatch.setattr(ft.time, "monotonic", lambda: clock[0])
    dog = StepWatchdog(threshold_x=2.0)

    def step(i, dt):
        dog.start()
        clock[0] += dt
        return dog.stop(i)
    flags = [step(i, 0.125) for i in range(12)]
    assert not any(flags)           # no outlier, and none before 10 steps
    assert step(12, 0.5)
    assert not step(13, 0.1875)     # 1.5x: under the threshold
    assert dog.slow_steps == [(12, 0.5, 0.125)]
    assert dog.median == 0.125


def test_watchdog_needs_ten_steps():
    dog = StepWatchdog()
    dog.times = [0.1] * 8
    dog._t0 = time.monotonic() - 10.0
    assert not dog.stop(8)          # 9 times: no median yet
    assert len(dog.times) == 9
