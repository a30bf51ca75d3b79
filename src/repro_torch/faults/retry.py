"""Bounded retry with exponential backoff and a per-call deadline budget.

The retry engine is deliberately separate from any subprocess plumbing
that serves an endpoint: tests drive it with fake callables, injected
``sleep`` and ``clock`` functions, and deterministic failure scripts, so
the backoff/budget semantics are pinned without spawning anything.

Semantics:

  * the first call is free; ``retries`` is the number of ADDITIONAL
    attempts after a retryable failure (``retries=0`` = fail fast),
  * attempt ``i`` (1-based) sleeps ``backoff_s * 2**(i-1)`` before
    retrying,
  * ``deadline_s`` is the total wall budget for the whole call: once it
    is spent, the last error propagates even if attempts remain (each
    attempt is additionally bounded by the caller's own per-attempt
    timeout — the budget bounds *when retrying stops*, it cannot
    interrupt an attempt in flight),
  * only ``retry_on`` errors retry; anything else (e.g. a malformed
    answer, which the same input would reproduce) propagates immediately.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

from repro_torch.faults.errors import LLMCrashError, LLMTimeoutError


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    retries: int = 2                    # additional attempts after the first
    backoff_s: float = 0.25             # base of the exponential backoff
    deadline_s: Optional[float] = None  # total wall budget across attempts
    retry_on: Tuple[type, ...] = (LLMCrashError, LLMTimeoutError)


def call_with_retries(fn: Callable[[], object], policy: RetryPolicy,
                      sleep: Callable[[float], None] = time.sleep,
                      clock: Callable[[], float] = time.monotonic):
    """Run ``fn`` under ``policy``; returns its value or raises its error."""
    start = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except policy.retry_on:
            attempt += 1
            if attempt > policy.retries:
                raise
            if policy.deadline_s is not None \
                    and clock() - start >= policy.deadline_s:
                raise
            delay = policy.backoff_s * (2.0 ** (attempt - 1))
            if policy.deadline_s is not None:
                delay = min(delay,
                            max(policy.deadline_s - (clock() - start), 0.0))
            if delay > 0.0:
                sleep(delay)


def with_retries(complete: Callable[[str], str], policy: RetryPolicy,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic
                 ) -> Callable[[str], str]:
    """Wrap a ``prompt -> completion`` callable with the retry policy."""
    def wrapped(prompt: str) -> str:
        return call_with_retries(lambda: complete(prompt), policy,
                                 sleep=sleep, clock=clock)
    return wrapped
