"""The program's ``repro.*`` spans in a traced run's profile, linked to the
device records they launched.

The port opens a span around each piece of a prefill's work
(``repro_torch.obs.spans``; the names are in ``docs/torch/observability.md``).
A device record belongs to the innermost ``repro.*`` span, on the launching
thread, that covers the start of the CUDA runtime or driver call that
launched it.  The profiler gives a kernel the correlation id of that call
(``cudaLaunchKernel``, ``cuLaunchKernel``, ...), so the link is exact; it is
never decided by overlap of device time with host spans, since a kernel
runs after its span has closed.

:func:`collect` reads a finished :class:`servebench.core.trace.Tracer`'s
profile events into a :class:`SpanTrace`: the harness's own :class:`Records`
(the same device records, and the host records without the spans, so that
idle gaps keep the names the harness gives them) and, beside them, the
spans, each device record's launch and the launches' starts and threads.
:func:`readings` gives the five per-layer readings of the spans and
:func:`breakdown` their two breakdown entries.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from servebench.core import trace as tr

PREFIX = "repro."
PREFILL, LAYER = "repro.prefill", "repro.layer"
NO_SPAN = "(no repro span)"
# device µs a prompt position of the kernels launched inside each span
PER_TOKEN = {"rms_norm.us_per_token": "repro.rms_norm",
             "rope.us_per_token": "repro.rope",
             "mlp_gate.us_per_token": "repro.mlp.gate"}

Span = Tuple[str, int, int, int]        # name, start, end (ns), thread


@dataclasses.dataclass
class SpanTrace:
    """``records``: the trace as the harness reads it, host records
    without the spans.  ``launch[i]``: the correlation id of the call that
    launched ``records.device[i]``.  ``calls``: correlation id -> (start,
    thread) of each runtime or driver call.  ``spans``: the ``repro.*``
    spans."""
    records: tr.Records
    launch: List[int]
    calls: Dict[int, Tuple[int, int]]
    spans: List[Span]

    def _in_window(self):
        """(index, start, end) of each device record, clipped to the
        window, as ``Records.clipped`` clips them."""
        lo, hi = self.records.window
        return [(i, max(s, lo), min(e, hi))
                for i, (_, s, e) in enumerate(self.records.device)
                if e > lo and s < hi]

    def chains(self) -> Dict[int, Tuple[str, ...]]:
        """Device record index -> the names of the spans open at its
        launch on the launching thread, outermost first (empty where it
        was launched outside every span or its launch is not in the
        trace)."""
        queries: Dict[int, List[Tuple[int, int]]] = {}
        out: Dict[int, Tuple[str, ...]] = {}
        for i, _, _ in self._in_window():
            call = self.calls.get(self.launch[i])
            if call is None:
                out[i] = ()
            else:
                queries.setdefault(call[1], []).append((call[0], i))
        by_thread: Dict[int, List[Span]] = {}
        for s in self.spans:
            by_thread.setdefault(s[3], []).append(s)
        for thread, qs in queries.items():
            spans = sorted(by_thread.get(thread, []), key=lambda s: s[1])
            stack: List[Span] = []
            j = 0
            # spans nest on a thread: the stack holds the open ones, the
            # innermost on top, so the ones that ended are popped from it
            for t, i in sorted(qs):
                while j < len(spans) and spans[j][1] <= t:
                    while stack and stack[-1][2] <= spans[j][1]:
                        stack.pop()
                    stack.append(spans[j])
                    j += 1
                while stack and stack[-1][2] <= t:
                    stack.pop()
                out[i] = tuple(s[0] for s in stack)
        return out

    def device_by_span(self, keep: Callable[[str], bool] = lambda n: True
                       ) -> Tuple[Dict[str, float], Dict[str, int]]:
        """Device seconds and device records by the innermost span of their
        launch (``NO_SPAN`` for the rest), over the window; only the
        records whose name ``keep`` takes."""
        chains = self.chains()
        seconds: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for i, s, e in self._in_window():
            if not keep(self.records.device[i][0]):
                continue
            name = chains[i][-1] if chains[i] else NO_SPAN
            seconds[name] = seconds.get(name, 0.0) + (e - s) * 1e-9
            counts[name] = counts.get(name, 0) + 1
        return seconds, counts

    def layer_launches(self) -> Optional[float]:
        """Device records launched inside a ``repro.layer`` span (at any
        depth), a layer."""
        layers = sum(s[0] == LAYER for s in self.spans)
        if not layers:
            return None
        inside = sum(LAYER in c for c in self.chains().values())
        return inside / layers if inside else None

    def prefill_idle_s(self) -> float:
        """Seconds of the window in which the device is idle and the host
        is inside a ``repro.prefill`` span."""
        # the union of the prefill spans, merged as device records are
        prefill = tr.Records(self.records.window,
                             [s[:3] for s in self.spans if s[0] == PREFILL],
                             []).busy_intervals()
        return _overlap(self.records.idle_gaps(), prefill) * 1e-9

    def idle_by_span(self) -> Dict[str, float]:
        """Idle device seconds by the innermost span covering each gap's
        middle, else by the harness's own rule (``Records.idle_by_host``:
        the innermost host record, then the harness's spans)."""
        spans = sorted(self.spans, key=lambda s: s[1])
        harness = sorted((r for r in self.records.host
                          if r[0].startswith("servebench.")),
                         key=lambda r: r[1])
        ops = sorted((r for r in self.records.host
                      if not r[0].startswith("servebench.")),
                     key=lambda r: r[1])
        out: Dict[str, float] = {}
        for s, e in self.records.idle_gaps():
            mid = (s + e) // 2
            name = (tr._covering(spans, mid, len(spans))
                    or tr._covering(ops, mid, tr.LOOKBACK)
                    or tr._covering(harness, mid, len(harness))
                    or "(no host record)")
            out[name] = out.get(name, 0.0) + (e - s) * 1e-9
        return out


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def collect(events) -> SpanTrace:
    """The spans and launch links of a finished :class:`tr.Tracer`'s
    profile (``tracer.prof.profiler.kineto_results.events()``).  The device
    records, the window and the host records other than the spans are those
    of ``tracer.records()``."""
    from torch.autograd import DeviceType
    device, launch, host, spans = [], [], [], []
    calls: Dict[int, Tuple[int, int]] = {}
    window = None
    for e in events:
        name = tr._get(e, "name")
        start = tr._get(e, "start_ns")
        end = start + tr._get(e, "duration_ns")
        if tr._get(e, "device_type") == DeviceType.CUDA:
            if not tr._get(e, "is_user_annotation") and tr.SPIN not in name:
                device.append((name, start, end))
                launch.append(tr._get(e, "correlation_id"))
        elif name == tr.SPAN:
            window = (start, end)
        elif name.startswith(PREFIX):
            spans.append((name, start, end, tr._get(e, "start_thread_id")))
        else:
            host.append((name, start, end))
            # a CUDA runtime or driver call (cudaLaunchKernel,
            # cuLaunchKernel, cudaMemcpyAsync, ...): its correlation id is
            # its device records'; an ATen op's may be the same number
            if name.startswith("cu"):
                calls[tr._get(e, "correlation_id")] = (
                    start, tr._get(e, "start_thread_id"))
    if window is None:
        raise RuntimeError(f"the trace holds no {tr.SPAN!r} span")
    return SpanTrace(tr.Records(window, device, host), launch, calls, spans)


def readings(st: SpanTrace, positions: int) -> Dict[str, float]:
    """The five readings of the spans, by metric name; a reading whose
    spans launched nothing in the window is left out."""
    seconds, _ = st.device_by_span()
    out: Dict[str, float] = {}
    for metric, name in PER_TOKEN.items():
        if seconds.get(name, 0.0) > 0 and positions:
            out[metric] = 1e6 * seconds[name] / positions
    lo, hi = st.records.window
    if any(s[0] == PREFILL for s in st.spans) and hi > lo:
        out["prefill.idle_share"] = 100.0 * st.prefill_idle_s() \
            / ((hi - lo) * 1e-9)
    launches = st.layer_launches()
    if launches is not None:
        out["layer.launches"] = launches
    return out


def breakdown(st: SpanTrace) -> dict:
    """``idle_by_span`` and ``device_by_span``, the ten largest each."""
    return {"idle_by_span": tr.top(st.idle_by_span()),
            "device_by_span": tr.top(st.device_by_span()[0])}
