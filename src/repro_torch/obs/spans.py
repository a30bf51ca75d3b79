"""Named spans on the model path, in ``torch.profiler``'s own trace.

``with span("repro.rms_norm"): ...`` marks the code that does a piece of a
model's work.  Under any ``torch.profiler`` session the span is a
``record_function`` range: it shares the device records' clock, and the
profiler links every kernel to the launch made inside it, so a reader of
the trace can put each kernel down to the innermost span that launched it
(``export_chrome_trace`` draws the spans on the device timeline too).

**The off-cost contract.**  With no profiler active, :func:`span` makes
one check of ``torch._C._autograd._profiler_enabled()`` and returns one
shared do-nothing context manager: no dispatcher call, no RecordFunction,
no object made.  A span therefore costs one predicate and an empty
``with`` when tracing is off; the values a model computes never depend on
whether it is on.

The names, and the metric that reads each, are in
``docs/torch/observability.md`` ("Model-path spans").  This module imports
only torch, so the model modules import it directly (``repro_torch.obs``
itself stays numpy-only for the simulator's engine).
"""
from __future__ import annotations

import torch
from torch._C._autograd import _profiler_enabled


class _Off:
    """The span of an untraced call: enters and exits doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A ``record_function(name)`` range while a profiler is active, else
    the shared no-op (one predicate; see the module's contract)."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
