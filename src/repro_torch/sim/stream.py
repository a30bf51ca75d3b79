"""Arrival streams: chunked, restartable request sources (O(window) memory).

The engine historically consumed a fully-materialized ``List[Request]`` —
O(n_requests) per replica, B× that under ``run_batch``.  An
:class:`ArrivalStream` replaces the list with a *restartable* sequence of
arrival-sorted chunks plus up-front metadata (``horizon``,
``n_requests``, ``info``), so the engine can heap-push one window at a
time and the generator layer never holds more than a chunk.

Contract (what the engine's windowed refill relies on):

  * ``chunks()`` returns a **fresh** iterator every call (restartable:
    the same stream object can feed many replicas, and a truncated run
    can still drain the remainder for exact accounting);
  * chunks are sorted by ``Request.arrival`` *and* the sort extends
    across chunk boundaries (``chunk[k][-1].arrival <=
    chunk[k+1][0].arrival``);
  * every iteration yields **independent** Request objects (either
    freshly generated, or cloned by :class:`ListStream`) — requests
    carry mutable runtime state, so replicas must not share them;
  * ``horizon`` is known before any chunk is pulled (the engine sizes
    its epoch schedule from it instead of scanning ``max(r.arrival)``).

Chunk *size* is a memory knob, never a semantics knob: a run over
``stream.rechunked(w)`` is discrete-outcome identical for every ``w``
(pinned by tests/test_streaming.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence

from repro_torch.sim.types import Request

__all__ = ["ArrivalStream", "ListStream", "as_arrival_stream"]


class ArrivalStream:
    """A restartable source of arrival-sorted Request chunks."""

    def __init__(self, factory: Callable[[], Iterator[List[Request]]], *,
                 horizon: float, n_requests: Optional[int] = None,
                 info: Optional[Dict] = None):
        self._factory = factory
        self.horizon = float(horizon)
        # nominal request count (generators may emit slightly fewer, e.g.
        # a RAN substream whose burst events run out) — advisory metadata;
        # exact accounting always comes from the engine's own counters
        self.n_requests = None if n_requests is None else int(n_requests)
        self.info: Dict = dict(info or {})

    # ------------------------------------------------------------------ #
    def chunks(self) -> Iterator[List[Request]]:
        """A fresh chunk iterator (one full pass over the stream)."""
        return self._factory()

    def to_list(self) -> List[Request]:
        """Materialize one pass into a plain list."""
        out: List[Request] = []
        for chunk in self.chunks():
            out.extend(chunk)
        return out

    def materialize(self) -> "ListStream":
        """A fully-materialized stream with the SAME metadata.

        This is the reference side of the streamed ≡ materialized
        equivalence contract: it shares ``horizon`` (hence the epoch
        schedule) with the source, so the only difference a run can see
        is chunk granularity — which must not matter.
        """
        return ListStream(self.to_list(), horizon=self.horizon,
                          n_requests=self.n_requests, info=self.info,
                          clone=True)

    def rechunked(self, window: int) -> "ArrivalStream":
        """The same stream re-buffered into chunks of ``window`` requests."""
        window = int(window)
        if window <= 0:
            raise ValueError(f"window must be > 0 (got {window})")
        src = self

        def factory() -> Iterator[List[Request]]:
            buf: List[Request] = []
            for chunk in src.chunks():
                buf.extend(chunk)
                while len(buf) >= window:
                    yield buf[:window]
                    buf = buf[window:]
            if buf:
                yield buf
        return ArrivalStream(factory, horizon=self.horizon,
                             n_requests=self.n_requests, info=self.info)

    def transformed(self, fn_factory: Callable[[], Callable[[List[Request]],
                                                            List[Request]]]
                    ) -> "ArrivalStream":
        """A per-chunk transform view (fresh transform state per pass).

        ``fn_factory()`` is called once per ``chunks()`` iteration and
        must return the chunk-mapping function — stateful transforms
        (e.g. a seeded RNG consumed in stream order) stay restartable.
        """
        src = self

        def factory() -> Iterator[List[Request]]:
            fn = fn_factory()
            return (fn(chunk) for chunk in src.chunks())
        return ArrivalStream(factory, horizon=self.horizon,
                             n_requests=self.n_requests, info=self.info)


class ListStream(ArrivalStream):
    """A list-backed stream; the legacy path and the materialized side.

    ``window=None`` yields the whole list as ONE chunk (exactly the old
    bulk-heapify behavior); ``clone=True`` copies requests lazily per
    chunk at yield time — replicas never mutate the caller's objects,
    and the clone cost is paid per window, not up front.
    """

    def __init__(self, requests: Sequence[Request], *,
                 horizon: Optional[float] = None,
                 n_requests: Optional[int] = None,
                 info: Optional[Dict] = None,
                 window: Optional[int] = None, clone: bool = False):
        self.requests = list(requests)
        self.window = None if window is None else int(window)
        self.clone = bool(clone)
        if horizon is None:   # legacy fallback: scan the realized arrivals
            horizon = max((r.arrival for r in self.requests), default=0.0)
        super().__init__(self._iter, horizon=horizon,
                         n_requests=(len(self.requests) if n_requests is None
                                     else n_requests), info=info)

    def _iter(self) -> Iterator[List[Request]]:
        step = self.window or max(len(self.requests), 1)
        for lo in range(0, len(self.requests), step):
            chunk = self.requests[lo:lo + step]
            if self.clone:
                chunk = [dataclasses.replace(r) for r in chunk]
            yield chunk

    def materialize(self) -> "ListStream":
        return self


def as_arrival_stream(workload) -> ArrivalStream:
    """Coerce an engine workload argument (stream or list) to a stream.

    Plain lists keep the legacy semantics bit-for-bit: scanned horizon,
    one bulk chunk, per-run clones (now taken lazily at chunk load).
    """
    if isinstance(workload, ArrivalStream):
        return workload
    return ListStream(workload, clone=True)
