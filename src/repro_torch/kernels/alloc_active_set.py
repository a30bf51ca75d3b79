"""The closed-form deadline-aware allocator as a hand-written CUDA kernel.

Twin of the reference's ``kernels/alloc_active_set.py`` (a Pallas TPU
kernel, one grid step per node): one launch solves the Eq. 17-19 active-set
fixed point for every (node, resource) row of a fleet.  The kernel is
``csrc/alloc_active_set.cu`` and is f32 by design, held to the f64 host
solver by tolerance; this module is its launcher.  Rows of up to 1024 lanes
take the warp route (one warp a row, persistent CTAs fed tiles of rows by
bulk asynchronous copies); longer rows take one thread block each
(:func:`alloc_active_set_geometry` chooses).  The plain version is
:func:`repro_torch.kernels.ref.alloc_active_set_ref`.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# The limits below are the kernel's own (csrc/alloc_active_set.cu).
MAX_S = 8192             # longest row: 8 lanes on each of 1024 threads
WARP_MAX_S = 1024        # longest row one warp holds: 32 lanes a thread
MAX_ROWS = 16            # rows per tile
MAX_STAGES = 3           # tiles in the ring
MAX_WARPS = 8            # consumer warps per CTA (a producer warp besides)
RING_BYTES = 48 * 1024   # the ring's dynamic shared memory per CTA
MAX_CTAS_PER_SM = 4      # CTAs an SM holds at <= 4 lanes a thread
SMEM_PER_SM = 233472     # shared memory a Hopper SM shares among its CTAs
CTA_SMEM_EXTRA = 1024 + 16 * MAX_STAGES   # the system's 1 KB, mbarriers
BLOCK_THREADS = 256      # threads of a long row's block, 1024 past 2048 lanes
IN_BYTES_PER_LANE = 13   # psi, omega, floors (f32) and mask (u8) a lane


class Geometry(NamedTuple):
    route: str           # "warp" (S <= 1024) or "block"
    rows: int            # R: rows per tile (1 on the block route)
    stages: int          # tiles the ring holds; 0: plain loads, no ring
    ctas: int            # the grid
    warps: int           # consumer warps per CTA (block route: the row's)


def alloc_active_set_geometry(N: int, S: int,
                              sms: int = _build.H100_SMS) -> Geometry:
    """How the kernel covers an ``[N, S]`` fleet on a card of ``sms`` SMs.

    Warp route (``S <= 1024``): tile ``t`` is rows ``[t R, t R + R)``, one
    contiguous span of each input; ``R`` is a power of two and a multiple
    of ``16 / gcd(S, 16)``, so that every full tile's spans start and end on
    16 bytes (f32 and u8 alike), as large as 16 rows and ``stages`` tiles of
    ``13 R S`` bytes within ``RING_BYTES`` allow, then halved while the
    tiles are fewer than the SMs.  Each CTA holds ``min(8, R)`` consumer
    warps, one row at a time each, and walks tiles ``blockIdx, blockIdx +
    ctas, ...``; the grid is at most ``k * sms`` CTAs, ``k <= 4`` as many
    rings as an SM's shared memory holds.  A row too long for any aligned
    tile to fit the ring takes plain loads (``stages = 0``).  At ``(16384,
    128)`` on 132 SMs: R = 8, 3 stages of 13 KB, 528 CTAs of 8 + 1 warps.

    Block route (``S > 1024``): one CTA of 256 threads per row, 1024 once
    the row passes 8 lanes a thread."""
    if N < 1 or not 1 <= S <= MAX_S or sms < 1:
        raise ValueError(f"alloc_active_set_geometry: N={N}, S={S}, "
                         f"sms={sms} (need N, sms >= 1, 1 <= S <= {MAX_S})")
    if S > WARP_MAX_S:
        threads = BLOCK_THREADS if S <= 8 * BLOCK_THREADS else 1024
        return Geometry("block", 1, 0, N, threads // 32)
    unit = 16 // math.gcd(S, 16)
    rows = stages = 0
    for st in (MAX_STAGES, 2):
        fit = min(MAX_ROWS, RING_BYTES // (st * IN_BYTES_PER_LANE * S))
        if fit >= unit:
            rows, stages = 1 << (fit.bit_length() - 1), st
            break
    if stages:
        while rows % (2 * unit) == 0 and -(-N // rows) < sms:
            rows //= 2
        ring = stages * IN_BYTES_PER_LANE * rows * S
        per_sm = min(MAX_CTAS_PER_SM,
                     SMEM_PER_SM // (ring + CTA_SMEM_EXTRA))
    else:
        rows, per_sm = MAX_WARPS, MAX_CTAS_PER_SM
    return Geometry("warp", rows, stages, min(-(-N // rows), per_sm * sms),
                    min(MAX_WARPS, rows))


ROUTES = {"warp": 0, "block": 1}      # ROUTE_* in csrc/alloc_active_set.cu


@functools.lru_cache(maxsize=None)
def _geometry(N: int, S: int, index: int) -> Geometry:
    return alloc_active_set_geometry(N, S, _build.sm_count(index))


def alloc_active_set_cuda(psi: torch.Tensor, omega: torch.Tensor,
                          floors: torch.Tensor, capacity: torch.Tensor,
                          mask: torch.Tensor):
    """Launch the kernel on the current stream of the inputs' device.

    Inputs are prepared by :func:`repro_torch.kernels.ops.alloc_active_set`
    (contiguous f32 ``[N, S]``, ``capacity`` f32 ``[N]``, ``mask`` bool, one
    device); the split is :func:`alloc_active_set_geometry` on this card.
    Allocates the outputs, does not synchronise.  Returns ``(alloc f32,
    feasible bool [N], pinned bool [N, S])``.
    """
    N, S = psi.shape
    dev = psi.device
    geom = _geometry(N, S, dev.index)
    if geom.stages:                     # bulk copies start on 16 bytes
        psi, omega, floors, mask = (_build.aligned16(x)
                                    for x in (psi, omega, floors, mask))
    alloc = torch.empty((N, S), dtype=torch.float32, device=dev)
    feasible = torch.empty(N, dtype=torch.bool, device=dev)
    pinned = torch.empty((N, S), dtype=torch.bool, device=dev)
    # a bool is one byte, 0 or 1: the kernel reads and writes them as u8
    with _build.on_device(dev):
        _build.launch(
            "alloc_active_set",
            psi.data_ptr(), omega.data_ptr(), floors.data_ptr(),
            capacity.data_ptr(), mask.data_ptr(), alloc.data_ptr(),
            feasible.data_ptr(), pinned.data_ptr(), N, S,
            ROUTES[geom.route], geom.rows, geom.stages, geom.ctas,
            geom.warps, _build.current_stream(dev))
    return alloc, feasible, pinned
