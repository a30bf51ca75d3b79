"""The device trace of a traced run, reduced to what the per-layer readers
and the breakdown need.

The profiler (CPU and CUDA activity) covers the window's first pass over
the traffic, so that every seed's traced work is the same.  The span
``servebench.traced`` marks the traced window on the profiler's clock; a
throw-away spin kernel goes first, since the card's profiler has been seen
to lose the first kernel record of a trace.  Records are read from the
profiler's raw event list, which is fast, rather than from its
``FunctionEvent`` tree, which takes about a minute for half a million
records.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

SPAN = "servebench.traced"
SPIN = "spin_kernel"
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 200
# host records searched back from a gap for one that covers it, before the
# harness's own spans are asked
LOOKBACK = 256


def _get(e, attr):
    v = getattr(e, attr)
    return v() if callable(v) else v


class Tracer:
    """Profiles from :meth:`start` to :meth:`stop` (both synchronise)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.span = torch.autograd.profiler.record_function(SPAN)

    def start(self) -> None:
        self.prof.__enter__()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.span.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def records(self) -> "Records":
        from torch.autograd import DeviceType
        device, host = [], []
        window = None
        for e in self.prof.profiler.kineto_results.events():
            name = _get(e, "name")
            start = _get(e, "start_ns")
            end = start + _get(e, "duration_ns")
            annotation = _get(e, "is_user_annotation")
            if _get(e, "device_type") == DeviceType.CUDA:
                if not annotation and SPIN not in name:
                    device.append((name, start, end))
            elif name == SPAN:
                window = (start, end)
            else:
                host.append((name, start, end))
        if window is None:
            raise RuntimeError(f"the trace holds no {SPAN!r} span")
        return Records(window, device, host)


@dataclasses.dataclass
class Records:
    """A trace's window ``(start, end)`` and its device and host records
    ``(name, start, end)``, in nanoseconds on the profiler's clock."""
    window: Tuple[int, int]
    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]

    def clipped(self) -> List[Tuple[str, int, int]]:
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.device
                if e > lo and s < hi]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device records inside the window."""
        out: List[List[int]] = []
        for _, s, e in sorted(self.clipped(), key=lambda r: r[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def kernel_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.clipped():
            out[n] = out.get(n, 0.0) + (e - s) * 1e-9
        return out

    def idle_gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def idle_by_host(self) -> Dict[str, float]:
        """Idle device seconds by what the host was doing at the middle of
        each gap: the innermost host record covering it (an ATen operator,
        a CUDA runtime call or one of the harness's ``servebench.*``
        spans)."""
        spans = sorted((r for r in self.host
                        if r[0].startswith("servebench.")),
                       key=lambda r: r[1])
        ops = sorted((r for r in self.host
                      if not r[0].startswith("servebench.")),
                     key=lambda r: r[1])
        out: Dict[str, float] = {}
        for s, e in self.idle_gaps():
            mid = (s + e) // 2
            name = (_covering(ops, mid, LOOKBACK)
                    or _covering(spans, mid, len(spans))
                    or "(no host record)")
            out[name] = out.get(name, 0.0) + (e - s) * 1e-9
        return out


def _covering(records, t: int, lookback: int):
    """The name of the latest-starting of ``records`` (sorted by start)
    that covers ``t``, looking back ``lookback`` records at most."""
    j = bisect.bisect_right(records, t, key=lambda r: r[1]) - 1
    for i in range(j, max(j - lookback, -1), -1):
        if records[i][2] > t:
            return records[i][0]
    return None


def top(d: Dict[str, float], n: int = BREAKDOWN_ENTRIES) -> List[list]:
    return [[k[:NAME_CHARS], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


@dataclasses.dataclass
class TraceView:
    """What a per-layer reader reads: the traced window's seconds, the
    device's busy seconds in it, each kernel's device seconds, the calls
    served in it and the configuration's count of their work."""
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    calls: list
    work: Callable[[int, int], dict]
    peaks: dict

    def seconds_matching(self, pattern) -> float:
        return sum(v for k, v in self.kernel_s.items() if pattern.search(k))

    @property
    def positions(self) -> int:
        return sum(c.rows * c.positions for c in self.calls)

    def total(self, key: str) -> float:
        return float(sum(self.work(c.rows, c.positions)[key]
                         for c in self.calls))

    def kernel_calls(self, key: str) -> list:
        out = []
        for c in self.calls:
            out += self.work(c.rows, c.positions)[key]
        return out


def view(records: Records, calls: list, work, peaks: dict) -> TraceView:
    lo, hi = records.window
    busy = sum(e - s for s, e in records.busy_intervals())
    return TraceView(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                     kernel_s=records.kernel_seconds(), calls=calls,
                     work=work, peaks=peaks)


def breakdown(records: Records) -> dict:
    return {"device_ops": top(records.kernel_seconds()),
            "idle_gaps": top(records.idle_by_host())}
