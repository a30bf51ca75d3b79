"""repro_torch.faults — fault injection and graceful degradation.

Two timescales, one subsystem:

  * infrastructure faults — seed-deterministic spot-churn schedules
    (:func:`churn_schedule`) consumed by the ``spot-churn`` scenario
    family and the engine's time-varying node capacity,
  * agentic faults — the typed LLM-endpoint error taxonomy
    (:mod:`repro_torch.faults.errors`), the bounded-retry/backoff/deadline
    machinery (:mod:`repro_torch.faults.retry`), and deterministic flakiness
    injectors (:func:`flaky_complete`) that drive the degradation-ladder
    tests without subprocesses.

See ``docs/faults.md`` for the fault model and the degradation ladder.
"""
from repro_torch.faults.errors import (
    LLMCrashError,
    LLMEndpointError,
    LLMMalformedError,
    LLMTimeoutError,
    MalformedShortlistError,
)
from repro_torch.faults.retry import RetryPolicy, call_with_retries, with_retries
from repro_torch.faults.script import churn_schedule, fault_draw, flaky_complete

__all__ = [
    "LLMEndpointError",
    "LLMCrashError",
    "LLMTimeoutError",
    "LLMMalformedError",
    "MalformedShortlistError",
    "RetryPolicy",
    "call_with_retries",
    "with_retries",
    "churn_schedule",
    "fault_draw",
    "flaky_complete",
]
