"""Structured error taxonomy for the external-LLM placement path.

Three failure shapes reach the controller from a served endpoint:

  * **crash**     — the endpoint process died (nonzero exit, broken pipe),
  * **timeout**   — no answer within the per-attempt budget,
  * **malformed** — an answer arrived but nothing in it maps to a
    candidate action (garbage, refusals, truncated JSON).

All three subclass :class:`LLMEndpointError`, so the degradation ladder
(:class:`repro_torch.core.controller.HAFPlacement` falling back to its
stand-in agent) catches one type while the ``kind`` tag keeps the
failures attributable in traces and report rows.  Crash errors carry the
endpoint's stderr tail — the single most useful forensic when a sweep
degrades overnight.
"""
from __future__ import annotations


class LLMEndpointError(RuntimeError):
    """Base of the taxonomy; ``kind`` names the failure shape."""

    kind = "crash"

    def __init__(self, message: str, stderr_tail: str = ""):
        super().__init__(message)
        self.stderr_tail = stderr_tail


class LLMCrashError(LLMEndpointError):
    """The endpoint process exited nonzero (or could not be spawned)."""

    kind = "crash"


class LLMTimeoutError(LLMEndpointError):
    """No completion within the per-attempt timeout."""

    kind = "timeout"


class LLMMalformedError(LLMEndpointError):
    """A completion arrived but carried no recognizable shortlist."""

    kind = "malformed"


# the controller-facing alias: raised by ExternalLLMAgent.shortlist when
# parse_response maps nothing in the reply onto the candidate set
MalformedShortlistError = LLMMalformedError
