"""Failure injection + straggler tracking for fault-tolerance tests.

The training loop treats any exception from the step function as a node
failure: it restores from the latest checkpoint and resumes (the same
restart path a scheduler-driven relaunch takes on a real fleet).  The
injector deterministically raises at configured steps; the straggler
monitor flags steps whose wall time exceeds ``threshold ×`` the running
median — on a fleet this signal triggers hot-spare swap-in; here it is
surfaced in the step log and asserted on by tests.

A copy of the reference's ``distributed/failure.py``.
"""
from __future__ import annotations

import time
from typing import Iterable, List, Optional


class InjectedFailure(RuntimeError):
    """Simulated node failure."""


class FailureInjector:
    def __init__(self, fail_at_steps: Iterable[int] = ()):
        self.fail_at = set(fail_at_steps)
        self.fired: List[int] = []

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.append(step)
            raise InjectedFailure(f"injected node failure at step {step}")


class StragglerMonitor:
    def __init__(self, threshold: float = 3.0, window: int = 32):
        self.threshold = threshold
        self.window = window
        self.times: List[float] = []
        self.flagged: List[int] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        dt = time.monotonic() - (self._t0 or time.monotonic())
        recent = self.times[-self.window:]
        if len(recent) >= 8:
            med = sorted(recent)[len(recent) // 2]
            if dt > self.threshold * med:
                self.flagged.append(step)
        self.times.append(dt)
        return dt
