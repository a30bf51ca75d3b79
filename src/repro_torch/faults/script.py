"""Deterministic fault scripts: spot churn schedules and flaky-LLM wrappers.

Everything here is a pure function of its seed, so fault injection is
replayable bit-for-bit — the property the solo ≡ batched equivalence
suite and the chaos smoke tier lean on.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.faults.errors import LLMCrashError

__all__ = ["churn_schedule", "flaky_complete", "fault_draw"]


def churn_schedule(seed: int, n_nodes: int, horizon: float,
                   n_preemptions: int = 3, down_s: float = 30.0,
                   notice_s: float = 5.0, scale: float = 0.0,
                   flaps: int = 0, flap_scale: float = 0.5,
                   flap_s: float = 15.0,
                   window: Tuple[float, float] = (0.15, 0.7)
                   ) -> List[Dict[str, float]]:
    """Seed-deterministic spot-churn schedule.

    Returns a list of churn events, each a dict with keys

      ``node``    victim node index,
      ``notice``  time the advance preemption notice lands (varuna-style;
                  ``notice == depart`` means no warning),
      ``depart``  time the node's capacity drops to ``scale``,
      ``rejoin``  time it returns to full capacity,
      ``scale``   residual capacity fraction while down (0 = full
                  preemption, 0 < s < 1 = capacity flap).

    Departures land uniformly in ``window`` × ``horizon`` so short traces
    still see churn mid-flight.  Events are sorted by departure time; ties
    resolve by node index so the list (and hence the engine's heap
    sequence numbers) is deterministic.
    """
    rng = np.random.default_rng(seed)
    events: List[Dict[str, float]] = []
    for _ in range(int(n_preemptions)):
        node = int(rng.integers(0, n_nodes))
        depart = float(rng.uniform(window[0], window[1]) * horizon)
        events.append({
            "node": node,
            "notice": max(depart - float(notice_s), 0.0),
            "depart": depart,
            "rejoin": depart + float(down_s),
            "scale": float(scale),
        })
    for _ in range(int(flaps)):
        node = int(rng.integers(0, n_nodes))
        depart = float(rng.uniform(window[0], window[1]) * horizon)
        events.append({
            "node": node,
            "notice": depart,       # flaps hit without warning
            "depart": depart,
            "rejoin": depart + float(flap_s),
            "scale": float(flap_scale),
        })
    events.sort(key=lambda ev: (ev["depart"], ev["node"]))
    return events


def fault_draw(prompt: str, seed: int) -> float:
    """Uniform [0, 1) draw keyed on ``(seed, prompt)`` — stable across
    processes, so the same prompt under the same seed always lands on the
    same side of a fail-rate threshold (tests/mock_llm.py uses the same
    scheme)."""
    h = hashlib.sha256(f"{seed}:".encode() + prompt.encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


def flaky_complete(complete: Callable[[str], str], fail_rate: float,
                   seed: int = 0,
                   error: type = LLMCrashError) -> Callable[[str], str]:
    """Wrap an in-process completion callable with deterministic flakiness
    (for unit tests that exercise the degradation ladder without
    subprocesses)."""
    def wrapped(prompt: str) -> str:
        if fault_draw(prompt, seed) < fail_rate:
            raise error(f"injected fault (seed={seed}, "
                        f"fail_rate={fail_rate:g})")
        return complete(prompt)
    return wrapped
