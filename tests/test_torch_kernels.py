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
sums taken in another order).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.allocator_np import solve_resource_np
from repro.kernels import event_core as ref_event_core
from repro.kernels import event_step as ref_event_step
from repro.kernels import ops as ref_ops
from repro.sim.event_core import NumpyBatchedEventCore
from repro_torch import convert
from repro_torch.kernels import ops, ref

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


# --------------------------------------------------------------------------- #
# alloc_active_set
# --------------------------------------------------------------------------- #
def _alloc_inputs(seed, N, S):
    rng = np.random.default_rng(seed)
    psi = rng.uniform(0, 1e14, (N, S))
    omega = rng.uniform(0, 100, (N, S))
    cap = rng.uniform(5e13, 2e14, N)
    floors = np.where(rng.random((N, S)) < 0.3,
                      rng.uniform(0, 2e13, (N, S)), 0.0)
    mask = rng.random((N, S)) < 0.9
    return psi, omega, floors, cap, mask


ALLOC_CASES = [(seed, 4, S) for seed in range(4) for S in (1, 12, 37, 128)] \
    + [(7, 3, 200)]


@pytest.mark.parametrize("seed,N,S", ALLOC_CASES)
def test_alloc_ref_f32_matches_pallas_and_numpy(seed, N, S):
    psi, omega, floors, cap, mask = _alloc_inputs(seed, N, S)
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
    assert ops.launch_counts() == {"event_step": 0, "alloc_active_set": 0}
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
