"""Plain torch versions of the port's kernels against the reference.

The CUDA kernels themselves run only on a card (``chip_smoke.py`` holds
them against these plain versions there).  Here the same numpy inputs go
through the plain version and through the reference three ways: the Pallas
kernel in interpret mode, the jitted jnp form, and the numpy host core.

Tolerances: discrete outputs (``sid``, ``started``, ``feasible``) equal;
event floats BITWISE against the numpy core.  Against the jax forms (XLA
may contract ``rem - alloc*tg`` into a fused multiply-add, which differs by
an ulp of the 1e13-FLOP operands) times are held to ``rtol=0, atol=1e-9``
seconds and residual work to 1e-9 seconds of service at the lane's rate,
``|d rem| <= 1e-9 * alloc``.  Where a GPU stage ends inside the tick the
contracted form can leave a rounding residue ``rem_g > 0`` instead of the
exact 0 numpy gets, and then holds the CPU stage back for that tick: such
lanes are checked for exactly that (CPU residual untouched) and nothing
looser.  Allocator: ``rtol=1e-4, atol=cap*1e-5`` (f32
sums taken in another order).  Model kernels: the reference's own
tolerances, stated at their section below.
"""
import math
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.allocator_np import solve_resource_np
from repro.kernels import event_core as ref_event_core
from repro.kernels import event_step as ref_event_step
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kref
from repro.models.ssm import ssd_scan_ref as ref_model_ssd
from repro.sim.event_core import NumpyBatchedEventCore
from repro_torch import convert
from repro_torch.kernels import alloc_active_set as aas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.event_step import (MAX_CLUSTER, MAX_THREADS,
                                            event_step_geometry)
from repro_torch.models.ssm import ssd_scan_ref as port_model_ssd

INF = float("inf")


def _block(kind: str, seed: int, B: int, S: int):
    """The eight step inputs as numpy arrays."""
    rng = np.random.default_rng(seed)
    a = {
        "rem_g": np.where(rng.random((B, S)) < 0.7,
                          rng.uniform(1.0, 1e13, (B, S)), 0.0),
        "rem_c": np.where(rng.random((B, S)) < 0.7,
                          rng.uniform(1e-9, 2.0, (B, S)), 0.0),
        "alloc_g": rng.uniform(1e11, 1e14, (B, S)),
        "alloc_c": rng.uniform(0.1, 16.0, (B, S)),
        "avail": rng.random((B, S)) < 0.85,
        "t": rng.uniform(0.0, 50.0, B),
        "live": np.ones(B, bool),
    }
    a["t_ev"] = a["t"] + rng.uniform(0.0, 0.2, B)
    if kind == "stalled":        # pending stages with zero rate
        a["alloc_g"][rng.random((B, S)) < 0.4] = 0.0
        a["alloc_c"][rng.random((B, S)) < 0.4] = 0.0
    elif kind == "unavailable":
        a["avail"] = rng.random((B, S)) < 0.2
    elif kind == "dead-rows":
        a["live"] = rng.random(B) < 0.5
        a["live"][0] = False
    elif kind == "all-inf":      # nothing can complete in the even rows
        a["avail"][::2] = False
        a["t_ev"][0] = INF       # ... and row 0 has no timed event either
    elif kind == "ties":         # duplicated lanes: exact ties for the min
        for k in ("rem_g", "rem_c", "alloc_g", "alloc_c"):
            a[k][:, S // 2:] = a[k][:, :S - S // 2]
        a["avail"][:] = True
    elif kind == "heap-first":   # the timed event precedes every completion
        a["t_ev"] = a["t"] + 1e-7
    else:
        assert kind == "random"
    return a


EVENT_CASES = [("random", s, 4, S) for s in (0, 1) for S in (1, 7, 37, 128, 200)] \
    + [(k, 0, 5, S) for k in ("stalled", "unavailable", "dead-rows",
                               "all-inf", "ties", "heap-first")
       for S in (7, 130)]


def _ref_step(a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    out = ref.event_step_ref(*(t[k] for k in convert.STEP_INPUTS))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("kind,seed,B,S", EVENT_CASES)
def test_event_step_ref_bitwise_equals_numpy_core(kind, seed, B, S):
    a = _block(kind, seed, B, S)
    rg, rc, started, t_comp, sid = _ref_step(a)
    stub = types.SimpleNamespace(
        B=B, S=S, alloc_g=a["alloc_g"].copy(), alloc_c=a["alloc_c"].copy(),
        head_rem_g=a["rem_g"].copy(), head_rem_c=a["rem_c"].copy(),
        head_mask=a["avail"].copy(), reconfig_until=np.zeros((B, S)),
        head_started=np.zeros((B, S), bool))
    tc_np, sid_np = NumpyBatchedEventCore().step(
        stub, a["t"].copy(), a["t_ev"].copy(), a["live"].copy())
    assert sid.dtype == np.int32
    assert np.array_equal(sid, sid_np)
    assert np.array_equal(started, stub.head_started)
    # bitwise: compare the raw 64-bit patterns, not values
    for got, want in ((rg, stub.head_rem_g), (rc, stub.head_rem_c),
                      (t_comp, tc_np)):
        assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("form", ("pallas-interpret", "jnp"))
@pytest.mark.parametrize("kind,seed,B,S", EVENT_CASES)
def test_event_step_ref_matches_reference_kernels(kind, seed, B, S, form):
    a = _block(kind, seed, B, S)
    rg, rc, started, t_comp, sid = _ref_step(a)
    with jax.enable_x64(True):
        args = [jnp.asarray(a[k]) for k in convert.STEP_INPUTS]
        if form == "jnp":
            out = ref_event_core.event_step_jax(*args)
        else:
            out = ref_event_step.event_step(*args, interpret=True)
        j_rg, j_rc, j_started, j_tc, j_sid = (np.asarray(o) for o in out)
    assert j_rg.dtype == np.float64
    assert np.array_equal(sid, j_sid)
    assert np.array_equal(started, j_started)
    assert (np.abs(rg - j_rg) <= 1e-9 * a["alloc_g"]).all()
    residue = (rg <= 0.0) & (j_rg > 0.0)     # fused multiply-add artefact
    assert not ((rg > 0.0) & (j_rg <= 0.0)).any()
    assert (np.abs(rc - j_rc) <= 1e-9 * a["alloc_c"])[~residue].all()
    assert np.array_equal(j_rc[residue], a["rem_c"][residue])
    assert np.array_equal(np.isinf(t_comp), np.isinf(j_tc))
    fin = np.isfinite(t_comp)
    np.testing.assert_allclose(t_comp[fin], j_tc[fin], rtol=0, atol=1e-9)


def test_event_step_ref_never_nan_and_first_index():
    a = _block("stalled", 3, 6, 64)
    rg, rc, _, t_comp, _ = _ref_step(a)
    assert not np.isnan(rg).any() and not np.isnan(rc).any()
    assert not np.isnan(t_comp).any()
    a = _block("ties", 0, 3, 10)
    _, _, _, _, sid = _ref_step(a)
    assert (sid < 5).all()          # the first of each duplicated pair wins
    a = _block("all-inf", 0, 4, 9)
    _, _, _, t_comp, sid = _ref_step(a)
    assert np.isinf(t_comp[::2]).all() and (sid[::2] == 0).all()


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_solo_pair_matches_batched_row(seed):
    """next_completion_ref + advance_ref on one row are the fused step."""
    a = _block("stalled", seed, 1, 23)
    rg, rc, started, t_comp, sid = _ref_step(a)
    row = {k: torch.from_numpy(v[0]) for k, v in a.items() if v.ndim == 2}
    t = float(a["t"][0])
    best, s = ref.next_completion_ref(row["rem_g"], row["rem_c"],
                                      row["alloc_g"], row["alloc_c"],
                                      row["avail"], t)
    assert float(best) == t_comp[0] and int(s) == sid[0]
    dt = min(float(best), float(a["t_ev"][0])) - t
    rg1, rc1, st1 = ref.advance_ref(row["rem_g"], row["rem_c"],
                                    row["alloc_g"], row["alloc_c"],
                                    row["avail"], dt)
    assert np.array_equal(rg1.numpy(), rg[0])
    assert np.array_equal(rc1.numpy(), rc[0])
    assert np.array_equal(st1.numpy(), started[0])


def _kernel_lanes(S, geom):
    """The lanes each thread of a row's cluster handles as
    csrc/event_step.cu indexes them: ``[c, threads, k]`` (``-1`` where a
    thread has none).  Slot 0 is the lane held in registers,
    ``rank * threads + tid``; slots 1.. are the strided rest, ``c * threads``
    apart."""
    c, T = geom
    stride = c * T
    first = np.arange(stride).reshape(c, T)
    lanes = first[:, :, None] + stride * np.arange(max(1, -(-S // stride)))
    return np.where(lanes < S, lanes, -1)


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 300), S=st.integers(1, 40000),
       sms=st.sampled_from((132, 114, 1)))
def test_event_step_geometry_covers_every_lane_once(B, S, sms):
    """The kernel's split of a row (csrc/event_step.cu): at most 8 CTAs a
    cluster, CTAs of a multiple of 32 threads up to 1024, and every lane of
    [0, S) handled by exactly one thread, in registers or in the strided
    rest."""
    geom = event_step_geometry(B, S, sms)
    assert 1 <= geom.cluster <= MAX_CLUSTER
    assert geom.threads % 32 == 0 and 32 <= geom.threads <= MAX_THREADS
    lanes = _kernel_lanes(S, geom)
    assert lanes.shape[:2] == (geom.cluster, geom.threads)
    got = np.sort(lanes[lanes >= 0])
    assert np.array_equal(got, np.arange(S))
    # slot 0 (registers) is the contiguous lane rank * threads + tid
    assert np.array_equal(lanes[..., 0].ravel()[:min(S, lanes[..., 0].size)],
                          np.arange(min(S, lanes[..., 0].size)))


def test_event_step_geometry_at_the_main_shape():
    """run_batch's [32, 1440] on 132 SMs: 32 clusters of 4 CTAs of 384
    threads, one lane a thread; more rows than SMs give one-CTA clusters."""
    assert event_step_geometry(32, 1440) == (4, 384)
    assert _kernel_lanes(1440, event_step_geometry(32, 1440)).shape[2] == 1
    assert event_step_geometry(140, 1440).cluster == 1
    assert _kernel_lanes(20000, event_step_geometry(1, 20000)).shape[2] > 1


# --------------------------------------------------------------------------- #
# alloc_active_set
# --------------------------------------------------------------------------- #
# floors scale of each kind of data: "random" (at wide rows most floors sum
# past the capacity and are rescaled) and "feasible" (most rows keep theirs)
ALLOC_KINDS = {"random": 1.0, "feasible": 0.1}


def _alloc_inputs(seed, N, S, kind="random"):
    rng = np.random.default_rng(seed)
    psi = rng.uniform(0, 1e14, (N, S))
    omega = rng.uniform(0, 100, (N, S))
    cap = rng.uniform(5e13, 2e14, N)
    floors = np.where(rng.random((N, S)) < 0.3,
                      rng.uniform(0, 2e13, (N, S)), 0.0)
    mask = rng.random((N, S)) < 0.9
    return psi, omega, floors * ALLOC_KINDS[kind], cap, mask


# (seed, N, S, kind); then N that are not multiples of 16 (the kernel's
# tiles: a partial last tile) and the feasible-dominant kind
ALLOC_CASES = [(seed, 4, S, "random") for seed in range(4)
               for S in (1, 12, 37, 128)] + [(7, 3, 200, "random")] \
    + [(seed, N, S, "random") for seed, N, S in ((8, 17, 12), (9, 33, 37),
                                                 (10, 23, 128))] \
    + [(seed, N, S, "feasible") for seed, N, S in ((0, 4, 37), (1, 4, 128),
                                                   (2, 17, 128), (3, 9, 60))]


def _alloc_case_id(case):
    seed, N, S, kind = case        # the first cases keep their earlier ids
    return f"{seed}-{N}-{S}" + ("" if kind == "random" else f"-{kind}")


@pytest.mark.parametrize("seed,N,S,kind", ALLOC_CASES,
                         ids=[_alloc_case_id(c) for c in ALLOC_CASES])
def test_alloc_ref_f32_matches_pallas_and_numpy(seed, N, S, kind):
    psi, omega, floors, cap, mask = _alloc_inputs(seed, N, S, kind)
    t32 = [torch.from_numpy(x.astype(np.float32))
           for x in (psi, omega, floors, cap)]
    al, fe, pin = ref.alloc_active_set_ref(*t32, torch.from_numpy(mask))
    assert al.dtype == torch.float32
    k_al, k_fe, _ = ref_ops.alloc_active_set(
        jnp.asarray(psi), jnp.asarray(omega), jnp.asarray(floors),
        jnp.asarray(cap), jnp.asarray(mask))
    for n in range(N):
        a_np, f_np, _ = solve_resource_np(psi[n], omega[n], floors[n],
                                          float(cap[n]), mask[n])
        np.testing.assert_allclose(al[n].numpy(), a_np, rtol=1e-4,
                                   atol=cap[n] * 1e-5)
        np.testing.assert_allclose(al[n].numpy(), np.asarray(k_al[n]),
                                   rtol=1e-4, atol=cap[n] * 1e-5)
        assert bool(fe[n]) == bool(f_np) == bool(k_fe[n])
    assert not (pin.numpy() & ~mask).any()
    assert (al.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_alloc_ref_f64_and_infeasible_floors(seed):
    """dtype follows the inputs; floors that do not fit are scaled."""
    psi, omega, floors, cap, mask = _alloc_inputs(seed, 5, 16)
    floors = floors * 40.0           # sums far above the capacities
    al, fe, _ = ref.alloc_active_set_ref(
        *(torch.from_numpy(x) for x in (psi, omega, floors, cap, mask)))
    assert al.dtype == torch.float64
    for n in range(5):
        a_np, f_np, _ = solve_resource_np(psi[n], omega[n], floors[n],
                                          float(cap[n]), mask[n])
        np.testing.assert_allclose(al[n].numpy(), a_np, rtol=1e-9,
                                   atol=cap[n] * 1e-12)
        assert bool(fe[n]) == bool(f_np)
        assert al[n].sum() <= cap[n] * (1 + 1e-9)
    assert not fe.all()


def test_alloc_feasible_kind_keeps_most_floors():
    """The feasible-dominant data is what it says: most rows fit their
    floors, where the random kind's wide rows mostly do not."""
    fits = {}
    for kind in ALLOC_KINDS:
        psi, omega, floors, cap, mask = _alloc_inputs(0, 64, 128, kind)
        _, fe, _ = ref.alloc_active_set_ref(
            *(torch.from_numpy(x) for x in (psi, omega, floors, cap, mask)))
        fits[kind] = float(fe.double().mean())
    assert fits["feasible"] > 0.9 > 0.1 > fits["random"]


def _alloc_fixed_rounds(psi, omega, floors, capacity, mask):
    """The reference kernel's schedule: exactly S pinning rounds, no early
    stop (src/repro/kernels/alloc_active_set.py's fori_loop)."""
    S = psi.shape[-1]
    zero = torch.zeros_like(psi)
    cap = capacity[:, None]
    psi = torch.where(mask, psi.clamp_min(0.0), zero)
    omega = torch.where(mask, omega.clamp_min(0.0), zero)
    floors = torch.where(mask, floors.clamp_min(0.0), zero)
    w = torch.sqrt(omega * psi)
    floor_sum = floors.sum(dim=1, keepdim=True)
    feasible = floor_sum <= cap + 1e-6
    floors_eff = floors * torch.where(feasible, torch.ones_like(cap),
                                      cap / floor_sum.clamp_min(1e-9))

    def shares(pinned):
        rem = cap - torch.where(pinned, floors_eff, zero).sum(1, keepdim=True)
        denom = torch.where(pinned, zero, w).sum(1, keepdim=True)
        return w * rem.clamp_min(0.0) / denom.clamp_min(1e-9)

    pinned = w <= 0.0
    for _ in range(S):
        pinned = pinned | (shares(pinned) < floors_eff)
    alloc = torch.where(mask, torch.where(pinned, floors_eff, shares(pinned)),
                        zero)
    return alloc, feasible[:, 0], pinned & mask


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
@pytest.mark.parametrize("floor_scale", (1.0, 2.0, 4.0))
def test_alloc_early_stop_equals_fixed_rounds(dtype, floor_scale):
    """The plain version (and the kernel) stop a row at the first round that
    pins nothing new; S rounds give the same allocation, feasibility and
    pinned set, bit for bit, on random rows of random widths."""
    rng = np.random.default_rng(int(floor_scale * 10) + (dtype == np.float64))
    deep = 0
    for S in (1, 5, 32, 37, 100):
        N = 24
        psi = rng.uniform(0, 1e14, (N, S)) * (rng.random((N, S)) < 0.8)
        omega = rng.uniform(0, 100, (N, S))
        cap = rng.uniform(5e13, 2e14, N)
        # floors near each lane's proportional share, so pinning cascades
        w = np.sqrt(psi * omega)
        share = w * cap[:, None] / np.maximum(w.sum(1, keepdims=True), 1e-9)
        floors = share * rng.uniform(0.0, 2.0, (N, S)) * floor_scale \
            * (rng.random((N, S)) < 0.6)
        mask = rng.random((N, S)) < 0.85
        t = [torch.from_numpy(x.astype(dtype))
             for x in (psi, omega, floors, cap)] + [torch.from_numpy(mask)]
        got = ref.alloc_active_set_ref(*t)
        want = _alloc_fixed_rounds(*t)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)
        deep = max(deep, int(ref.alloc_active_set_rounds(*t).max()))
    assert deep >= 3          # some row needed rounds past the first pins


# --------------------------------------------------------------------------- #
# the kernel's split of a fleet (csrc/alloc_active_set.cu)
# --------------------------------------------------------------------------- #
def _cu_constants(path):
    """``constexpr int NAME = <integer product>;`` of a CUDA source."""
    out = {}
    text = path.read_text()
    for m in re.finditer(r"constexpr int (\w+) = ([\d\s*]+);", text):
        out[m.group(1)] = math.prod(int(x) for x in m.group(2).split("*"))
    return out


def test_alloc_geometry_limits_are_the_kernels():
    """The geometry's limits are the ones the kernel declares and checks."""
    cu = _cu_constants(pathlib.Path(aas.__file__).parent / "csrc"
                       / "alloc_active_set.cu")
    assert cu["WARP_MAX_S"] == aas.WARP_MAX_S
    assert cu["MAX_STAGES"] == aas.MAX_STAGES
    assert cu["MAX_CONSUMERS"] == aas.MAX_WARPS
    assert cu["RING_BYTES"] == aas.RING_BYTES
    assert cu["MAX_CTAS_PER_SM"] == aas.MAX_CTAS_PER_SM
    assert cu["IN_BYTES_PER_LANE"] == aas.IN_BYTES_PER_LANE
    assert cu["MAX_LPT"] * cu["MAX_THREADS"] == aas.MAX_S
    assert {"warp": cu["ROUTE_WARP"], "block": cu["ROUTE_BLOCK"]} \
        == aas.ROUTES


@settings(max_examples=400, deadline=None)
@given(N=st.integers(1, 70000), S=st.integers(1, 8192),
       sms=st.sampled_from((1, 66, 132)))
def test_alloc_geometry_tiles_every_row_once(N, S, sms):
    """Every row lies in exactly one tile and is solved by one warp; each
    full tile's spans start and end on 16 bytes for every array (f32 and
    the u8 mask); the ring fits the kernel's budget and the SM's shared
    memory; rows over 1024 lanes take the long-row route; the grid is at
    most k * sms CTAs."""
    g = aas.alloc_active_set_geometry(N, S, sms)
    if S > aas.WARP_MAX_S:
        assert (g.route, g.rows, g.stages, g.ctas) == ("block", 1, 0, N)
        threads = 32 * g.warps
        assert threads <= 1024 and -(-S // threads) <= 8
        return
    assert g.route == "warp"
    R, W = g.rows, g.warps
    assert 1 <= W <= min(aas.MAX_WARPS, R) and 1 <= R <= aas.MAX_ROWS
    assert R & (R - 1) == 0 and R % W == 0   # every warp, R / W rows a tile
    tiles = -(-N // R)
    assert 1 <= g.ctas <= min(tiles, aas.MAX_CTAS_PER_SM * sms)
    # the kernel's walk: CTA c takes tiles c, c + ctas, ...; warp w of it
    # rows w, w + W, ... of each tile
    walk = np.concatenate([np.arange(c, tiles, g.ctas)
                           for c in range(g.ctas)])
    rows = (walk[:, None] * R + np.arange(R)[None, :]).ravel()
    by_warp = np.concatenate([np.arange(w, R, W) for w in range(W)])
    assert np.array_equal(np.sort(by_warp), np.arange(R))
    assert np.array_equal(np.bincount(rows[rows < N], minlength=N),
                          np.ones(N, int))
    assert g.stages in (0, 2, 3)
    if g.stages:
        for elem in (4, 1):                 # psi / omega / floors, mask
            assert (R * S * elem) % 16 == 0  # tile t starts at t R S elem
        ring = g.stages * aas.IN_BYTES_PER_LANE * R * S
        assert ring <= aas.RING_BYTES
        per_sm = -(-g.ctas // sms)
        assert per_sm * (ring + aas.CTA_SMEM_EXTRA) <= aas.SMEM_PER_SM
    else:                                   # no aligned tile fits the ring
        unit = 16 // math.gcd(S, 16)
        assert 2 * aas.IN_BYTES_PER_LANE * unit * S > aas.RING_BYTES


def test_alloc_geometry_at_the_timed_shapes():
    """(16384, 128): tiles of 8 rows in 3 stages, 4 CTAs an SM of 8
    consumer warps; (1024, 64): tiles cut to 4 rows so that every SM has
    one; S = 1024 is the warp route's widest row, 1025 the first long one."""
    assert aas.alloc_active_set_geometry(16384, 128) == ("warp", 8, 3, 528, 8)
    assert aas.alloc_active_set_geometry(1024, 64) == ("warp", 4, 3, 256, 4)
    assert aas.alloc_active_set_geometry(8, 1024).route == "warp"
    assert aas.alloc_active_set_geometry(8, 1025) == ("block", 1, 0, 8, 8)
    assert aas.alloc_active_set_geometry(2, 3000).warps == 32
    with pytest.raises(ValueError):
        aas.alloc_active_set_geometry(1, aas.MAX_S + 1)


# --------------------------------------------------------------------------- #
# wrappers on the CPU: plain version, no launch counted, inputs checked
# --------------------------------------------------------------------------- #
def test_ops_event_step_on_cpu_is_the_plain_version_and_counts_nothing():
    ops.reset_launch_counts()
    a = _block("random", 0, 3, 19)
    t = convert.block_arrays_to_torch(a, "cpu")
    out = ops.event_step(*(t[k] for k in convert.STEP_INPUTS))
    want = ref.event_step_ref(*(t[k] for k in convert.STEP_INPUTS))
    for o, w in zip(out, want):
        assert torch.equal(o, w)
    counts = ops.launch_counts()
    assert {"event_step", "alloc_active_set"} <= set(counts)
    assert set(counts.values()) == {0}
    back = convert.block_arrays_from_torch(
        dict(zip(convert.STEP_OUTPUTS, out)))
    assert back["sid"].dtype == np.int32 and back["started"].dtype == bool


@pytest.mark.parametrize("bad", ("dtype", "contiguity", "shape", "empty"))
def test_ops_event_step_rejects_bad_inputs(bad):
    a = _block("random", 0, 3, 8)
    t = convert.block_arrays_to_torch(a, "cpu")
    if bad == "dtype":
        t["rem_g"] = t["rem_g"].float()
    elif bad == "contiguity":
        t["alloc_c"] = t["alloc_c"].t().contiguous().t()
    elif bad == "shape":
        t["t_ev"] = t["t_ev"][:2]
    else:
        t = {k: v[:0] for k, v in t.items()}
    with pytest.raises(ValueError, match="event_step"):
        ops.event_step(*(t[k] for k in convert.STEP_INPUTS))


def test_ops_alloc_active_set_on_cpu_casts_to_f32_and_limits_rows():
    ops.reset_launch_counts()
    psi, omega, floors, cap, mask = _alloc_inputs(0, 3, 10)
    al, fe, pin = ops.alloc_active_set(
        *(torch.from_numpy(x) for x in (psi, omega, floors, cap, mask)))
    assert al.dtype == torch.float32 and fe.dtype == torch.bool
    assert pin.dtype == torch.bool
    assert ops.launch_counts()["alloc_active_set"] == 0
    wide = torch.zeros(1, 8193)
    with pytest.raises(ValueError, match="row limit"):
        ops.alloc_active_set(wide, wide, wide, torch.ones(1), wide > 0)


def test_ops_alloc_active_set_converts_only_what_needs_it():
    """Inputs that are already contiguous float32 / bool pass through
    untouched; float64, non-contiguous, integer-mask and [N, 1] capacity
    inputs give the same result as explicitly converted ones, in the same
    dtypes, with no launch counted on the CPU."""
    ops.reset_launch_counts()
    psi, omega, floors, cap, mask = _alloc_inputs(3, 6, 20)
    t32 = [torch.from_numpy(x.astype(np.float32))
           for x in (psi, omega, floors, cap)] + [torch.from_numpy(mask)]
    for x in t32:
        want = torch.float32 if x.is_floating_point() else torch.bool
        assert ops._as_contiguous(x, want) is x
    want = ops.alloc_active_set(*t32)
    odd = [torch.from_numpy(np.ascontiguousarray(x.T)).T
           for x in (psi, omega, floors)]           # float64, transposed
    assert not odd[0].is_contiguous()
    got = ops.alloc_active_set(*odd, torch.from_numpy(cap)[:, None],
                               torch.from_numpy(mask.astype(np.int32)))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert ops.launch_counts()["alloc_active_set"] == 0


@pytest.mark.parametrize("bad", ("omega", "floors", "mask", "capacity",
                                 "psi"))
def test_ops_alloc_active_set_rejects_bad_shapes(bad):
    t = dict(zip(("psi", "omega", "floors", "capacity", "mask"),
                 (torch.from_numpy(x) for x in _alloc_inputs(0, 4, 9))))
    if bad == "psi":
        t["psi"] = t["psi"][0]
    elif bad == "capacity":
        t["capacity"] = t["capacity"][:3]
    else:
        t[bad] = t[bad][:, :8]
    error = RuntimeError if bad == "capacity" else ValueError
    with pytest.raises(error, match="alloc_active_set" if bad != "capacity"
                       else "shape"):
        ops.alloc_active_set(*t.values())


# --------------------------------------------------------------------------- #
# model kernels: plain versions against the reference's Pallas kernels
# (interpret mode) and its oracles.  Tolerances are the reference's own
# (tests/test_kernels.py): flash f32 1e-5 / bf16 2e-2 (rtol, atol 10x),
# ssd 1e-4, rmsnorm f32 1e-5 / bf16 2e-2.
# --------------------------------------------------------------------------- #


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


FLASH_SHAPES = [(2, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 256, 4, 1, 32),
                (1, 512, 2, 2, 128), (3, 64, 6, 3, 16), (2, 128, 4, 4, 80)]


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("B,S,H,KV,d", FLASH_SHAPES)
def test_flash_attention_plain_matches_reference_kernel(B, S, H, KV, d, dtype,
                                                        causal):
    rng = np.random.default_rng(B * 1000 + S + H)
    q, k, v = (_normal(rng, (B, S, n, d)) for n in (H, KV, KV))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ref_ops.flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal), np.float32)
    got = ops.flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, H, d)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * 10)


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("B,S,H,KV,d", [(2, 300, 14, 2, 64), (1, 77, 4, 2, 32),
                                        (2, 1, 2, 1, 16)])
def test_flash_attention_plain_ragged_lengths_match_reference_oracle(
        B, S, H, KV, d, causal):
    """Prompt lengths that no power-of-two block divides (qwen2's head
    layout at S = 300), against the reference's oracle in float32."""
    rng = np.random.default_rng(S)
    q, k, v = (_normal(rng, (B, S, n, d)) for n in (H, KV, KV))
    want = np.asarray(ref_kref.attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("B,S,H,KV", [(1, 96, 4, 4), (2, 160, 8, 8),
                                      (1, 1, 2, 2)])
def test_flash_attention_plain_head_dim_80_matches_reference_kernel(
        B, S, H, KV, dtype):
    """zamba2's head dim (80: no power of two, staged in 128-column tiles on
    the card) with its GQA 1:1, causal, at lengths that end inside the
    kernel's 64-row tile, against the reference's Pallas kernel in interpret
    mode (its wrapper halves the block until it divides S)."""
    rng = np.random.default_rng(S + H + 80)
    q, k, v = (_normal(rng, (B, S, n, 80)) for n in (H, KV, KV))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ref_ops.flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=True), np.float32)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), causal=True)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, H, 80)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * 10)


def test_flash_head_dims_are_the_kernels_instantiations():
    """``HEAD_DIMS``, which the wrapper checks, is the set of head dims the
    CUDA source instantiates (its ``REPRO_FLASH_CASE`` switch)."""
    from repro_torch.kernels import flash_attention as fa
    src = (pathlib.Path(fa.__file__).parent / "csrc"
           / "flash_attention.cu").read_text()
    cases = tuple(int(d) for d in re.findall(
        r"^\s*REPRO_FLASH_CASE\((\d+)\)", src, re.M))
    assert cases == fa.HEAD_DIMS == (16, 32, 64, 80, 128, 224)


def _flash_tiles_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool, block: int = 64) -> torch.Tensor:
    """The rounding points of the bf16 tensor-core kernel
    (``csrc/flash_attention.cu``), in float32 on the CPU: scores of the bf16
    ``q, k`` in float32; per 64-key tile the running max, ``P = 2^(s c - m c)``
    with ``c = log2(e) / sqrt(d)``, the ``alpha`` rescale of ``l`` and of the
    float32 accumulator; P rounded to
    bf16 against the running max before ``P v`` (the reference oracle's
    ``probs.astype(v.dtype)``), ``l`` summing the unrounded P.  Returns
    float32; the kernel rounds that to bf16."""
    B, S, H, d = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, d).permute(0, 2, 3, 1, 4)
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    scale_log2 = torch.tensor(1.0 / np.sqrt(d) * np.log2(np.e),
                              dtype=torch.float32)
    m = torch.full(qf.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    pos = torch.arange(S)
    for k0 in range(0, S, block):
        s = qf @ kf[..., k0:k0 + block, :].transpose(-1, -2)
        if causal:
            s = torch.where(pos[k0:k0 + block][None, :] <= pos[:, None], s,
                            torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * scale_log2)
        p = torch.exp2(s * scale_log2 - m_new * scale_log2)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[..., k0:k0 + block, :]
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, d)


def _flash_source() -> str:
    from repro_torch.kernels import flash_attention as fa
    return (pathlib.Path(fa.__file__).parent / "csrc"
            / "flash_attention.cu").read_text()


def _flash_key_tile(src: str) -> int:
    """The bf16 route's key tile (``BK``) in ``csrc/flash_attention.cu``."""
    return int(re.search(r"constexpr int BK = (\d+);", src).group(1))


def _hold_tiles_emulation(B, S, H, KV, d, causal, block=64):
    """The emulation at key tile ``block`` against the Pallas kernel (in
    blocks of 128, or one block of S) and the float32 oracle."""
    rng = np.random.default_rng(B * 1000 + S + H + 7)
    q, k, v = (_normal(rng, (B, S, n, d)) for n in (H, KV, KV))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    pallas_block = 128 if S % 128 == 0 else S
    pallas = np.asarray(ref_ops.flash_attention(
        jq, jk, jv, causal=causal, block_q=pallas_block,
        block_k=pallas_block), np.float32)
    oracle = np.asarray(ref_kref.attention_ref(
        *(a.astype(jnp.float32) for a in (jq, jk, jv)), causal=causal))
    got = _flash_tiles_emulation(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal,
        block).numpy()
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-1)
    assert np.abs(got - oracle).max() < 2e-2


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("B,S,H,KV,d", FLASH_SHAPES + [(2, 300, 14, 2, 64)])
def test_flash_attention_bf16_tile_rounding_matches_reference(B, S, H, KV, d,
                                                              causal):
    """The tensor-core kernel's arithmetic (emulated above) against the
    reference's Pallas kernel in bf16 (interpret mode) and its float32
    oracle, at the reference's bf16 bar (rtol 2e-2, atol 2e-1); the
    emulation stays within 2e-2 of the oracle everywhere.  qwen2's head
    layout at S = 300 runs the Pallas kernel as one block of 300."""
    _hold_tiles_emulation(B, S, H, KV, d, causal)


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("B,S,H,KV", [(1, 300, 4, 4), (2, 256, 2, 2),
                                      (1, 77, 2, 2)])
def test_flash_attention_bf16_d80_route_matches_reference(B, S, H, KV,
                                                          causal):
    """Head dim 80's own route (``flash_tc80_kernel``), emulated at its key
    tile, against the reference's Pallas kernel in bf16 (interpret) and its
    float32 oracle at the bf16 bar: zamba2's GQA 1:1 at a ragged 300 (a
    128-row block whose second warpgroup holds no row), two whole 128-row
    blocks, and 77 rows (a block whose second warpgroup holds 13)."""
    _hold_tiles_emulation(B, S, H, KV, 80, causal,
                          _flash_key_tile(_flash_source()))


def test_flash_head_dim_80_tile_plan_is_exactly_80_columns():
    """The d = 80 route's tile plan in ``csrc/flash_attention.cu``: its TMA
    boxes' columns sum to 80, each box's columns fill its swizzle row (32,
    64 or 128 bytes), so no box is zero fill, and the route steps by the
    key tile that the emulation above takes."""
    src = _flash_source()
    cols = [int(c) for c in re.search(
        r"D80_BOX_COLS\[2\] = \{(\d+), (\d+)\}", src).groups()]
    row_b = [int(c) for c in re.search(
        r"D80_BOX_ROW_B\[2\] = \{(\d+), (\d+)\}", src).groups()]
    assert sum(cols) == 80
    assert all(r in (32, 64, 128) and 2 * c == r
               for c, r in zip(cols, row_b))
    assert _flash_key_tile(src) == 64
    assert re.search(r"constexpr int D80_BK = BK;", src)


def _flash128_key_tile(src: str) -> int:
    """The d = 128 route's key tile (``D128_BK``)."""
    return int(re.search(r"constexpr int D128_BK = (\d+);", src).group(1))


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("B,S,H,KV", [(1, 300, 8, 2), (2, 256, 4, 1),
                                      (1, 77, 4, 1)])
def test_flash_attention_bf16_d128_route_matches_reference(B, S, H, KV,
                                                           causal):
    """Head dim 128's own route (``flash_tc128_kernel``), emulated at its
    key tile, against the reference's Pallas kernel in bf16 (interpret) and
    its float32 oracle at the bf16 bar: llava's GQA 4:1 at a ragged 300 (a
    128-row block whose second warpgroup holds no row), two whole 128-row
    blocks, and 77 rows (a block whose second warpgroup holds 13)."""
    _hold_tiles_emulation(B, S, H, KV, 128, causal,
                          _flash128_key_tile(_flash_source()))


def test_flash_head_dim_128_tile_plan_is_two_full_boxes():
    """The d = 128 route's tile plan in ``csrc/flash_attention.cu``: its TMA
    boxes' columns sum to 128, each box's columns fill its swizzle row, its
    key tile (the one the emulation above takes) is 128, and
    ``launch_tc<128>`` reaches ``flash_tc128_kernel``: no head dim is left
    on the d <= 64 tile."""
    src = _flash_source()
    cols = [int(c) for c in re.search(
        r"D128_BOX_COLS\[2\] = \{(\d+), (\d+)\}", src).groups()]
    row_b = [int(c) for c in re.search(
        r"D128_BOX_ROW_B\[2\] = \{(\d+), (\d+)\}", src).groups()]
    assert sum(cols) == 128
    assert all(r in (32, 64, 128) and 2 * c == r
               for c, r in zip(cols, row_b))
    assert _flash128_key_tile(src) == 128
    launcher = re.search(r"cudaError_t launch_tc<128>\(.*?\n}", src,
                         re.S).group(0)
    assert "launch_tc128(" in launcher
    assert re.search(r"static_assert\(D == 16 \|\| D == 32 \|\| D == 64",
                     src)


SSD_SHAPES = [(2, 128, 4, 1, 32, 64, 32), (1, 256, 8, 2, 64, 128, 64),
              (2, 64, 2, 1, 16, 32, 64), (1, 96, 3, 1, 32, 16, 32),
              (1, 300, 4, 1, 64, 128, 300), (1, 64, 80, 1, 64, 64, 32)]


def _ssd_inputs(seed, b, s, h, g, p, n):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, s, h, p)),
            rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 1.5, h).astype(np.float32),
            _normal(rng, (b, s, g, n)), _normal(rng, (b, s, g, n)))


@pytest.mark.parametrize("port_form", ("sequential", "chunked"))
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SSD_SHAPES)
def test_ssd_scan_plain_forms_match_both_reference_forms(b, s, h, g, p, n,
                                                         chunk, port_form):
    """The port's sequential recurrence (``ops.ssd_scan`` on the CPU) and its
    chunked model form against the reference's Pallas kernel (interpret)
    and its sequential oracle, y and final state at 1e-4.  The last two
    shapes are mamba2's head layout as one chunk of 300 and zamba2's (80
    heads of 64, d_state 64, one group) over two chunks."""
    arrays = _ssd_inputs(s + h, b, s, h, g, p, n)
    tin = [torch.from_numpy(a) for a in arrays]
    if port_form == "sequential":
        y, st = ops.ssd_scan(*tin, chunk=chunk)
    else:
        y, st = port_model_ssd(*tin, chunk=min(chunk, s))
    jin = [jnp.asarray(a) for a in arrays]
    for form, (y_r, st_r) in (
            ("pallas", ref_ops.ssd_scan(*jin, chunk=chunk)),
            ("sequential", ref_kref.ssd_scan_sequential_ref(*jin))):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-4,
                                   atol=1e-4, err_msg=form)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_r), rtol=1e-4,
                                   atol=1e-4, err_msg=form)


# the shapes above, plus chunks that S does not divide (a ragged last chunk
# of 8 and of 2)
SSD_CHUNKED_SHAPES = SSD_SHAPES + [(1, 200, 4, 2, 32, 64, 64),
                                   (2, 130, 2, 1, 16, 32, 64)]


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SSD_CHUNKED_SHAPES)
def test_ssd_chunked_ref_matches_pallas_and_sequential(b, s, h, g, p, n,
                                                       chunk):
    """The state-passing form (the bf16 kernel's algorithm) in float32
    against the reference's Pallas kernel (interpret; its wrapper halves the
    chunk until it divides S) and its sequential oracle, y and final state
    at 1e-4."""
    arrays = _ssd_inputs(s + h + 1, b, s, h, g, p, n)
    y, st = ref.ssd_scan_chunked_ref(*(torch.from_numpy(a) for a in arrays),
                                     chunk=chunk)
    jin = [jnp.asarray(a) for a in arrays]
    for form, (y_r, st_r) in (
            ("pallas", ref_ops.ssd_scan(*jin, chunk=chunk)),
            ("sequential", ref_kref.ssd_scan_sequential_ref(*jin))):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-4,
                                   atol=1e-4, err_msg=form)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_r), rtol=1e-4,
                                   atol=1e-4, err_msg=form)


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", [
    (1, 300, 2, 1, 64, 128, 300), (1, 512, 2, 1, 64, 128, 64),
    (1, 256, 4, 2, 64, 128, 64), (1, 192, 3, 1, 20, 36, 64),
    (1, 200, 4, 2, 32, 64, 64), (1, 256, 80, 1, 64, 64, 64),
    (1, 512, 80, 1, 64, 64, 256)])
def test_ssd_chunked_ref_bf16_points_meet_the_bf16_bar(b, s, h, g, p, n,
                                                       chunk):
    """With the bf16 kernel's rounding points (hi / lo bf16 pairs for w, the
    masked scores and the carried state), the chunked form stays within the
    reference's bf16 bar (rtol = atol = 2e-2) of the reference's sequential
    oracle and of the port's on the same bf16 inputs — mamba2's one chunk of
    300 and eight chunks of 64 at S = 512, and zamba2's geometry (80 heads
    of 64, d_state 64, one group) over its two chunks of 256, included —
    and differs from the unrounded form."""
    tin = [torch.from_numpy(a).bfloat16()
           for a in _ssd_inputs(s + p, b, s, h, g, p, n)]
    y, st = ref.ssd_scan_chunked_ref(*tin, chunk=chunk, bf16_points=True)
    assert y.dtype == st.dtype == torch.bfloat16
    jin = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tin]
    for form, (y_r, st_r) in (
            ("reference", ref_kref.ssd_scan_sequential_ref(*jin)),
            ("port", (t.float().numpy()
                      for t in ref.ssd_scan_sequential_ref(*tin)))):
        for got, want in ((y, y_r), (st, st_r)):
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want, np.float32),
                rtol=2e-2, atol=2e-2, err_msg=form)
    y_exact, _ = ref.ssd_scan_chunked_ref(*(t.float() for t in tin),
                                          chunk=chunk)
    assert not torch.equal(y.float(), y_exact.bfloat16().float())


def test_ssd_chunked_ref_single_bf16_points_miss_the_bf16_bar():
    """Why the bf16 kernel carries hi / lo pairs: one bf16 rounding at each
    of its points misses the 2e-2 bar against the reference's sequential
    oracle at mamba2's head width over eight chunks, where the pairs meet
    it.  (The largest error grows with the number of outputs: chip_smoke.py
    reports both shares at the served shape.)"""
    b, s, h, g, p, n, chunk = 2, 512, 4, 1, 64, 128, 64
    tin = [torch.from_numpy(a).bfloat16()
           for a in _ssd_inputs(s + p, b, s, h, g, p, n)]
    jin = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tin]
    want = np.asarray(ref_kref.ssd_scan_sequential_ref(*jin)[0], np.float32)

    def share(pairs):
        y, _ = ref.ssd_scan_chunked_ref(*tin, chunk=chunk, bf16_points=True,
                                        bf16_pairs=pairs)
        return float(np.max(np.abs(y.float().numpy() - want)
                            / (2e-2 + 2e-2 * np.abs(want))))

    assert share(True) <= 1.0 < share(False)


def test_ssd_wrapper_constants_are_the_kernels():
    """The bf16 launcher's geometry in ``kernels/ssd_scan.py`` is the CUDA
    source's: the widest head and state, the chunk count up to which no
    pass kernel runs, and the state tile width NT of the wrapper's scratch
    (64 up to n = 64 with an even count of heads a group, else 128)."""
    from repro_torch.kernels import ssd_scan as ssd
    src = (pathlib.Path(ssd.__file__).parent / "csrc"
           / "ssd_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("MAX_P"), const("MAX_N"), const("FOLD_CHUNKS")) \
        == (ssd.MAX_P, ssd.MAX_N, ssd.FOLD_CHUNKS)
    assert "if (nx > 64 || (h / g) % 2)" in src
    assert [ssd.state_cols(nx, 2) for nx in (8, 40, 64, 72, 128)] \
        == [64, 64, 64, 128, 128]
    assert [ssd.state_cols(nx, hpg)
            for nx, hpg in ((40, 3), (64, 1), (64, 80))] == [128, 128, 64]


def test_ssd_model_form_matches_reference_model_form():
    arrays = _ssd_inputs(9, 2, 128, 4, 1, 32, 64)
    y, st = port_model_ssd(*(torch.from_numpy(a) for a in arrays), chunk=32)
    y_r, st_r = ref_model_ssd(*(jnp.asarray(a) for a in arrays), chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_r), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", [(4, 64, 256), (128, 512), (3, 5, 7, 64),
                                   (16, 896), (5, 999)])
def test_rmsnorm_plain_matches_reference_kernel_and_oracle(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x, w = _normal(rng, shape), _normal(rng, shape[-1:])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = ops.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w))
    assert got.dtype == tdt and tuple(got.shape) == shape
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (ref_ops.rmsnorm(jnp.asarray(x, jdt), jnp.asarray(w)),
                 ref_kref.rmsnorm_ref(jnp.asarray(x, jdt), jnp.asarray(w))):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


def test_model_kernel_wrappers_on_cpu_count_nothing_and_check_inputs():
    ops.reset_launch_counts()
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    ops.flash_attention(q, kv, kv)
    ops.rmsnorm(q, torch.ones(16))
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in _ssd_inputs(0, 1, 12, 2, 1, 8, 4))
    y, st = ops.ssd_scan(x, dt, A, B, C, chunk=8)
    assert y.dtype == st.dtype == torch.float32
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(NotImplementedError, match="initial_state"):
        ops.ssd_scan(x, dt, A, B, C, initial_state=st)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="H % KV"):
        ops.flash_attention(torch.zeros(1, 8, 3, 16), kv, kv)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(torch.zeros(1, 8, 4, 24), torch.zeros(1, 8, 2, 24),
                            torch.zeros(1, 8, 2, 24))
    ops.flash_attention(torch.zeros(1, 8, 4, 80), torch.zeros(1, 8, 4, 80),
                        torch.zeros(1, 8, 4, 80))
    with pytest.raises(ValueError, match="like the first input"):
        ops.ssd_scan(x, dt.to(torch.bfloat16), A, B, C)
    with pytest.raises(ValueError, match="weight"):
        ops.rmsnorm(q, torch.ones(8))
