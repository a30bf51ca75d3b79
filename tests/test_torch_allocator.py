"""repro_torch's allocator and active-set solvers against the reference's.

The torch closed form is held to the reference's tolerance
(``rtol=1e-4, atol=cap*1e-5``: the reference runs f32 under jax's default
dtypes); the numpy host solvers (``allocator_np``, ``cluster._active_set_*``)
are the bit-for-bit event-schedule contract and are compared BITWISE.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocator as ref_alloc
from repro.core import allocator_np as ref_np
from repro.sim import cluster as ref_cluster
from repro_torch.core import allocator, allocator_np
from repro_torch.sim import cluster

S = 12


def _rand_inputs(seed, S=S, tight=False):
    rng = np.random.default_rng(seed)
    psi = np.where(rng.random(S) < 0.8, rng.uniform(0, 1e14, S), 0.0)
    omega = np.where(psi > 0, rng.uniform(0.1, 1e3, S), 0.0)
    cap = float(rng.uniform(5e13, 2e14))
    floors = np.where(rng.random(S) < 0.3,
                      rng.uniform(0, (3.0 if tight else 0.15) * cap, S), 0.0)
    mask = rng.random(S) < 0.9
    return psi, omega, floors, cap, mask


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("tight", (False, True))
@pytest.mark.parametrize("seed", range(8))
def test_solve_resource_matches_reference(seed, tight):
    psi, omega, floors, cap, mask = _rand_inputs(seed, tight=tight)
    res = allocator.solve_resource(_t(psi), _t(omega), _t(floors), cap,
                                   _t(mask))
    want = ref_alloc.solve_resource(jnp.asarray(psi), jnp.asarray(omega),
                                    jnp.asarray(floors), jnp.asarray(cap),
                                    jnp.asarray(mask))
    a_np, f_np, _ = ref_np.solve_resource_np(psi, omega, floors, cap, mask)
    assert res.alloc.dtype == torch.float64          # follows the inputs
    np.testing.assert_allclose(res.alloc.numpy(), np.asarray(want.alloc),
                               rtol=1e-4, atol=cap * 1e-5)
    np.testing.assert_allclose(res.alloc.numpy(), a_np, rtol=1e-9,
                               atol=cap * 1e-12)
    assert bool(res.feasible) == bool(want.feasible) == bool(f_np)
    assert float(res.alloc.sum()) <= cap * (1 + 1e-9)
    assert not (res.floored.numpy() & ~mask).any()


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("seed", range(4))
def test_allocate_cluster_plain_matches_reference(seed, dtype):
    rng = np.random.default_rng(seed)
    N = 5
    rows = [_rand_inputs(100 * seed + n) for n in range(N)]
    psi_g = np.stack([r[0] for r in rows])
    omega = np.stack([r[1] for r in rows])
    fg = np.stack([r[2] for r in rows])
    cap_g = np.array([r[3] for r in rows])
    mask = np.stack([r[4] for r in rows])
    psi_c = rng.uniform(0, 4.0, (N, S))
    fc = np.where(rng.random((N, S)) < 0.3, rng.uniform(0, 2.0, (N, S)), 0.0)
    cap_c = rng.uniform(8.0, 64.0, N)
    args = (psi_g, psi_c, omega, fg, fc, cap_g, cap_c)
    g, c = allocator.allocate_cluster(*(_t(x, dtype) for x in args),
                                      _t(mask), use_kernel=False)
    g2, c2 = allocator.allocate_cluster(*(_t(x, dtype) for x in args),
                                        _t(mask))       # None -> plain on CPU
    assert torch.equal(g.alloc, g2.alloc) and torch.equal(c.alloc, c2.alloc)
    rg, rc = ref_alloc.allocate_cluster(*(jnp.asarray(x) for x in args),
                                        jnp.asarray(mask), use_kernel=False)
    assert g.alloc.dtype == dtype
    for got, want, cap in ((g, rg, cap_g), (c, rc, cap_c)):
        for n in range(N):
            np.testing.assert_allclose(
                got.alloc[n].numpy(), np.asarray(want.alloc[n]), rtol=1e-4,
                atol=cap[n] * 1e-5)
        assert np.array_equal(got.feasible.numpy(),
                              np.asarray(want.feasible))
    gn, cn, feas = allocator_np.allocate_cluster_np(*args, mask)
    np.testing.assert_allclose(g.alloc.numpy(), gn, rtol=1e-4,
                               atol=cap_g.max() * 1e-5)
    assert np.array_equal((g.feasible & c.feasible).numpy(), feas)


def test_allocate_node_decouples():
    psi, omega, floors, cap, mask = _rand_inputs(3)
    psi_c = psi / 1e13
    g, c = allocator.allocate_node(_t(psi), _t(psi_c), _t(omega), _t(floors),
                                   _t(floors) * 0, cap, 32.0, _t(mask))
    g1 = allocator.solve_resource(_t(psi), _t(omega), _t(floors), cap,
                                  _t(mask))
    assert torch.equal(g.alloc, g1.alloc)
    assert float(c.alloc.sum()) <= 32.0 * (1 + 1e-9)


@pytest.mark.parametrize("seed", range(4))
def test_urgency_and_ran_floor_match_reference(seed):
    rng = np.random.default_rng(seed)
    rem = rng.uniform(-0.5, 2.0, 40)
    active = rng.random(40) < 0.7
    got = allocator.urgency(_t(rem), _t(active))
    want = ref_alloc.urgency(jnp.asarray(rem), jnp.asarray(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    psi = rng.uniform(0, 1e13, 40)
    cap = rng.uniform(5e13, 2e14, 40)
    pend = rng.random(40) < 0.6
    fl, inf_ = allocator.ran_floor(_t(psi), _t(rem), _t(cap), _t(pend))
    rfl, rinf = ref_alloc.ran_floor(jnp.asarray(psi), jnp.asarray(rem),
                                    jnp.asarray(cap), jnp.asarray(pend))
    np.testing.assert_allclose(fl.numpy(), np.asarray(rfl), rtol=1e-5)
    assert np.array_equal(inf_.numpy(), np.asarray(rinf))


@pytest.mark.parametrize("seed", range(3))
def test_closed_form_is_the_numeric_argmin(seed):
    """Projected gradient on Eq. 16 cannot beat the closed form."""
    rng = np.random.default_rng(seed)
    S_ = 6
    psi = _t(rng.uniform(1.0, 10.0, S_))
    omega = _t(rng.uniform(0.5, 2.0, S_))
    floors = _t(np.where(rng.random(S_) < 0.4, rng.uniform(0, 2.0, S_), 0.0))
    mask = torch.ones(S_, dtype=torch.bool)
    cap = 20.0
    closed = allocator.solve_resource(psi, omega, floors, cap, mask).alloc
    numeric = allocator.solve_numeric(psi, omega, floors, cap, mask,
                                      steps=1500)
    f_closed = float(allocator.objective(closed, psi, omega, mask))
    f_num = float(allocator.objective(numeric, psi, omega, mask))
    assert float(numeric.sum()) <= cap * (1 + 1e-6)
    assert (numeric >= floors - 1e-9).all()
    assert f_closed <= f_num * (1 + 1e-6)
    assert f_num <= f_closed * 1.05           # and the oracle gets close


def test_use_kernel_true_needs_cuda_tensors():
    psi, omega, floors, cap, mask = _rand_inputs(0)
    a = [_t(x)[None] for x in (psi, psi, omega, floors, floors)]
    caps = torch.tensor([cap])
    with pytest.raises(RuntimeError, match="CUDA"):
        allocator.allocate_cluster(*a, caps, caps, _t(mask)[None],
                                   use_kernel=True)


# --------------------------------------------------------------------------- #
# host solvers: bit-for-bit the reference's
# --------------------------------------------------------------------------- #
def _bits(x):
    return np.asarray(x, np.float64).view(np.int64)


@pytest.mark.parametrize("tight", (False, True))
@pytest.mark.parametrize("seed", range(6))
def test_allocator_np_bitwise(seed, tight):
    psi, omega, floors, cap, mask = _rand_inputs(seed, tight=tight)
    a, f, p = allocator_np.solve_resource_np(psi, omega, floors, cap, mask)
    ra, rf, rp = ref_np.solve_resource_np(psi, omega, floors, cap, mask)
    assert np.array_equal(_bits(a), _bits(ra)) and f == rf
    assert np.array_equal(p, rp)
    w = np.sqrt(psi * omega)
    a, f, p = allocator_np.active_set_np(w, floors, cap, mask)
    ra, rf, rp = ref_np.active_set_np(w, floors, cap, mask)
    assert np.array_equal(_bits(a), _bits(ra)) and f == rf


@pytest.mark.parametrize("floors_on", (False, True))
@pytest.mark.parametrize("seed", range(6))
def test_active_set_rows_and_scalar_bitwise(seed, floors_on):
    rng = np.random.default_rng(seed)
    P, K = 5, 8
    w = np.where(rng.random((P, K)) < 0.8, rng.uniform(0, 1e8, (P, K)), 0.0)
    floors = np.where(rng.random((P, K)) < 0.4,
                      rng.uniform(0, 6e13, (P, K)), 0.0) * floors_on
    caps = rng.uniform(5e13, 2e14, P)
    got = cluster._active_set_rows(w.copy(), floors.copy(), caps.copy())
    want = ref_cluster._active_set_rows(w.copy(), floors.copy(), caps.copy())
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(cluster._tree_sum(w)),
                          _bits(ref_cluster._tree_sum(w)))
    for p in range(P):
        s_got = cluster._active_set_scalar(list(w[p]), list(floors[p]),
                                           float(caps[p]))
        s_want = ref_cluster._active_set_scalar(list(w[p]), list(floors[p]),
                                                float(caps[p]))
        assert np.array_equal(_bits(s_got), _bits(s_want))
        assert np.array_equal(_bits(s_got), _bits(got[p]))   # scalar ≡ rows
