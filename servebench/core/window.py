"""The measured window: one client in a closed loop over
``Model.prefill``.

A call is one batch of equal-length prompts; it starts when the previous
call's first tokens are on the host.  A request's first token is the argmax
of the last-position logits that ``prefill`` returns, copied to the host
(with a flag of whether the row's logits are finite).  The window starts
when the loop does and runs whole passes over the traffic: it closes when
the first pass to end after ``seconds`` have passed ends, so that every
seed's window holds the same lengths (a pass is a few seconds: at most
3.4 s in these cells).  Every call of the window counts whole.  The calls
the check keeps (``keep``, of the first pass) hold on to their prompts and
last-position logits, copied to the host once their first tokens are
there, so that the window's memory is serving's alone; the check serves
their caches again after the window (``reserve``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Set

import torch

from servebench.core.traffic import Call


@dataclasses.dataclass
class Served:
    call: Call
    start: float          # perf_counter seconds at the prefill call
    end: float            # ... once its first tokens are on the host
    host: torch.Tensor    # [2, rows]: served tokens, finite flags


@dataclasses.dataclass
class Kept:
    served: Served
    batch: Dict[str, torch.Tensor]   # on the host
    logits: torch.Tensor             # [rows, V], the last position, host


@dataclasses.dataclass
class Window:
    start: float
    end: float
    served: List[Served]          # the window's calls
    kept: Dict[int, Kept]         # call index -> what the check needs
    traced: List[Served]          # the calls inside the traced window

    @property
    def seconds(self) -> float:
        return self.end - self.start


def first_tokens(model, params, batch):
    """One call: ``prefill``, then its first tokens and finite flags on the
    host.  Returns (last-position logits, host [2, rows]); the cache is
    dropped on return, before the next call."""
    with torch.profiler.record_function("servebench.prefill"):
        logits, _ = model.prefill(params, batch)
        last = logits[:, -1]
    with torch.profiler.record_function("servebench.first_token"):
        host = torch.stack([last.argmax(-1),
                            torch.isfinite(last).all(-1).long()]).cpu()
    return last, host


def serve(model, params, calls: Iterator[Call],
          make_batch: Callable[[Call], dict], seconds: float,
          keep: Set[int], sync: Callable[[], None], pass_calls: int,
          tracer=None) -> Window:
    """Run the window (see the module docstring); a pass is
    ``pass_calls`` calls.  With a ``tracer`` the first pass is traced and
    the profiler is stopped before the next call."""
    served: List[Served] = []
    kept: Dict[int, Kept] = {}
    traced: List[Served] = []
    window_end: Optional[float] = None
    sync()
    if tracer is not None:
        tracer.start()
    start = time.perf_counter()
    deadline = start + seconds
    with torch.inference_mode():
        while window_end is None:
            call = next(calls)
            batch = make_batch(call)
            t0 = time.perf_counter()
            last, host = first_tokens(model, params, batch)
            t1 = time.perf_counter()
            s = Served(call, t0, t1, host)
            served.append(s)
            if call.index in keep:
                kept[call.index] = Kept(
                    s, {k: v.cpu() for k, v in batch.items()}, last.cpu())
            del last, batch
            if tracer is not None and call.index + 1 == pass_calls:
                tracer.stop()
                traced = list(served)
                tracer = None
            if t1 >= deadline and (call.index + 1) % pass_calls == 0:
                window_end = t1
    return Window(start, window_end, served, kept, traced)


def reserve(model, params, kept: Kept, device: torch.device):
    """A kept call served again on the same model after the window: its
    prompts (back on ``device``) and the cache that ``prefill`` returns."""
    batch = {k: v.to(device) for k, v in kept.batch.items()}
    with torch.inference_mode():
        _, cache = model.prefill(params, batch)
    return batch, cache
