"""The port's allocation baselines against the reference's, on the CPU:
equal bandwidth, the FEDL solve and its pieces, the §VI-A λ tuning, SAO's
KKT box correction and Algorithm 6, on ``sample_fleet(100, seed)``'s
first ten devices with the energy budgets of ``tests/test_sao.py``.

Tolerances: equal bandwidth has no iteration (rtol 1e-5); the FEDL pieces
are 40- to 60-step fp32 bisections that can end one step apart (rtol
1e-3, the λ bisection 1e-2); SAO and Algorithm 6 keep SAO's outer band
(rtol 2e-3)."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import baselines as ref_bl
from repro.core import wireless as ref_w
from repro.core.power import optimal_transmit_power as ref_power
from repro.core.sao import solve_sao as ref_solve_sao

from repro_torch.core import baselines as bl
from repro_torch.core import wireless as w
from repro_torch.core.power import optimal_transmit_power
from repro_torch.core.sao import solve_sao

B_MHZ = 20.0
SEEDS = (0, 1, 2)
FEDL_RTOL = 1e-3


def _arrs(seed, n=10, e_lo=0.03, e_hi=0.06):
    """The reference's and the port's arrays of one fleet."""
    def sel(mod):
        return mod.sample_fleet(100, seed=seed, e_cons_range=(e_lo, e_hi)) \
            .select(np.arange(n))
    return ref_w.fleet_arrays(sel(ref_w)), w.fleet_arrays(sel(w))


def _folded(seed):
    ra, pa = _arrs(seed)
    return ref_w.effective_arrays(ra), w.effective_arrays(pa)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("real", [None, 7, 0])
def test_equal_bandwidth_matches_reference(seed, real):
    """No mask, a mask of 7 real lanes of 10, and an all-False mask
    (T = 0)."""
    ra, pa = _arrs(seed)
    if real is None:
        want, got = ref_bl.equal_bandwidth(ra, B_MHZ), bl.equal_bandwidth(
            pa, B_MHZ)
    else:
        m = np.arange(10) < real
        want = ref_bl.equal_bandwidth(ra, B_MHZ, mask=jnp.asarray(m))
        got = bl.equal_bandwidth(pa, B_MHZ, mask=torch.tensor(m))
    for k in ("T", "b", "f", "e"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-5)
    np.testing.assert_array_equal(got.feasible.numpy(),
                                  np.asarray(want.feasible))
    if real == 0:
        assert float(got.T) == 0.0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("T", [0.2, 0.25, 0.4])
def test_b_required_and_waterfill_match_reference(seed, T):
    ra, pa = _folded(seed)
    want = np.asarray(ref_bl._b_required(jnp.float32(T), ra))
    got = bl._b_required(torch.tensor(T), pa).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    want = np.asarray(ref_bl._waterfill_b(jnp.float32(T), ra, B_MHZ))
    got = bl._waterfill_b(torch.tensor(T), pa, B_MHZ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_form_slope_is_the_autograd_slope(seed):
    """``_slope`` against ``torch.autograd`` of the summed energy, at bands
    where the frequency is clipped (wide and narrow) and where it is not,
    for three deadlines."""
    _, pa = _folded(seed)
    gz2 = 2.0 * pa["G"] * pa["z"]
    for T in (0.15, 0.25, 0.5):
        T = torch.tensor(T)
        for band in (0.3, 1.0, 2.0, 6.0):
            b = torch.linspace(0.5, 1.5, 10) * band
            b.requires_grad_(True)
            energy, _ = bl._device_energy(b, T, pa)
            (auto,) = torch.autograd.grad(energy.sum(), b)
            closed = bl._slope(b.detach(), T, pa, gz2)
            np.testing.assert_allclose(closed.numpy(), auto.numpy(),
                                       rtol=1e-5)


def _ref_objectives(ra, B, lam, n_grid, mask=None):
    """The reference's per-deadline objective vector: the body of
    ``repro.core.baselines._fedl_solve`` up to its ``argmin``."""
    n = ra["J"].shape[0] if mask is None else jnp.maximum(jnp.sum(mask), 1)
    T_min = ref_w.masked_max(ref_w.LN2 * ra["z"] / ra["J"]
                             + ra["U"] / ra["f_max"], mask) * 1.02
    T_max = ref_w.masked_max(
        ra["z"] / ref_bl._Q(jnp.float32(B) / n * 0.05, ra["J"])
        + ra["U"] / ra["f_min"], mask)
    Ts = jnp.exp(jnp.linspace(jnp.log(T_min), jnp.log(T_max), n_grid))

    def eval_T(T):
        b = ref_bl._waterfill_b(T, ra, jnp.float32(B), mask=mask)
        e, _ = ref_bl._device_energy(b, T, ra)
        infeasible = ref_w.masked_sum(ref_bl._b_required(T, ra), mask) > B
        obj = ref_w.masked_sum(e, mask) + lam * T
        return jnp.where(infeasible, jnp.inf, obj)

    return np.asarray(jax.jit(lambda: lax.map(eval_T, Ts))())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lam", [0.2, 4.58, 1000.0])
@pytest.mark.parametrize("n_grid", [60, 120])
def test_fedl_lambda_matches_reference(seed, lam, n_grid):
    ra, pa = _folded(seed)
    want = ref_bl.fedl_lambda(ra, B_MHZ, lam, n_grid)
    got = bl.fedl_lambda(pa, B_MHZ, lam, n_grid)
    obj_ref = float(jnp.sum(want.e) + lam * want.T)
    obj_port = float(torch.sum(got.e) + lam * got.T)
    np.testing.assert_allclose(obj_port, obj_ref, rtol=FEDL_RTOL)

    ref_objs = _ref_objectives(ra, B_MHZ, lam, n_grid)
    _, objs, *_ = bl._fedl_grid(pa, B_MHZ, lam, n_grid, None)
    objs = objs.numpy()
    np.testing.assert_array_equal(np.isinf(objs), np.isinf(ref_objs))
    fin = np.isfinite(ref_objs)
    np.testing.assert_allclose(objs[fin], ref_objs[fin], rtol=FEDL_RTOL)
    # the same grid deadline, unless the reference's best two are a tie
    best2 = np.sort(ref_objs)[:2]
    if not np.isclose(best2[1], best2[0], rtol=FEDL_RTOL):
        assert int(np.argmin(objs)) == int(np.argmin(ref_objs))
        np.testing.assert_allclose(float(got.T), float(want.T),
                                   rtol=FEDL_RTOL)
        for k in ("b", "f", "e"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=FEDL_RTOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_fedl_lambda_with_a_mask_matches_reference(seed):
    """Three padding lanes of ten: the solve sees seven devices."""
    ra, pa = _folded(seed)
    m = np.arange(10) < 7
    want = ref_bl.fedl_lambda(ra, B_MHZ, 4.58, 60, mask=jnp.asarray(m))
    got = bl.fedl_lambda(pa, B_MHZ, 4.58, 60, mask=torch.tensor(m))
    np.testing.assert_allclose(float(got.T), float(want.T), rtol=FEDL_RTOL)
    np.testing.assert_allclose(got.e.numpy(), np.asarray(want.e),
                               rtol=FEDL_RTOL)
    assert not got.b[~torch.tensor(m)].any()
    ref_objs = _ref_objectives(ra, B_MHZ, 4.58, 60, jnp.asarray(m))
    _, objs, *_ = bl._fedl_grid(pa, B_MHZ, 4.58, 60, torch.tensor(m))
    fin = np.isfinite(ref_objs)
    np.testing.assert_array_equal(np.isfinite(objs.numpy()), fin)
    np.testing.assert_allclose(objs.numpy()[fin], ref_objs[fin],
                               rtol=FEDL_RTOL)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("iters", [12, 24])
def test_tune_fedl_lambda_matches_reference(seed, iters):
    """The same λ within rtol 1e-2; above the bracket's floor (where some
    λ met every budget) no device is over its energy budget at the port's
    λ."""
    ra, pa = _folded(seed)
    want = float(ref_bl.tune_fedl_lambda(ra, B_MHZ, iters=iters))
    got = float(bl.tune_fedl_lambda(pa, B_MHZ, iters=iters))
    np.testing.assert_allclose(got, want, rtol=1e-2)
    if got > np.float32(1e-3):
        e = bl.fedl_lambda(pa, B_MHZ, got).e
        assert float(torch.max(e - pa["e_cons"])) <= 1e-6


@pytest.mark.parametrize("seed", SEEDS + (3, 4))
def test_solve_sao_box_correct_matches_reference(seed):
    ra, pa = _arrs(seed)
    want = ref_solve_sao(ra, B_MHZ, box_correct=True)
    got = solve_sao(pa, B_MHZ, box_correct=True)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(float(got.T), float(want.T), rtol=2e-3)
    np.testing.assert_allclose(float(got.b.sum()), float(jnp.sum(want.b)),
                               rtol=2e-3)


def test_optimal_transmit_power_matches_reference():
    """Algorithm 6 on the fixture of ``tests/test_power.py``."""
    def fleet(mod):
        return mod.sample_fleet(100, seed=0, e_cons_range=(35e-3, 35e-3)) \
            .select(np.arange(10))
    want = ref_power(fleet(ref_w), B_MHZ, p_min_dbm=10, p_max_dbm=23)
    got = optimal_transmit_power(fleet(w), B_MHZ, p_min_dbm=10,
                                 p_max_dbm=23, device="cpu")
    assert len(got.history) == len(want.history)
    np.testing.assert_allclose(got.p_star_watt, want.p_star_watt, rtol=2e-3)
    np.testing.assert_allclose(got.p_star_dbm, want.p_star_dbm, rtol=2e-3)
    np.testing.assert_allclose(got.T_star, want.T_star, rtol=2e-3)


def test_with_power_and_round_totals_match_reference():
    rf = ref_w.sample_fleet(12, seed=5).with_power(0.05)
    pf = w.sample_fleet(12, seed=5).with_power(0.05)
    np.testing.assert_array_equal(pf.p, rf.p)
    np.testing.assert_array_equal(pf.J_mhz(), rf.J_mhz())
    assert w.watt_to_dbm(0.2) == ref_w.watt_to_dbm(0.2)
    ra, pa = ref_w.fleet_arrays(rf), w.fleet_arrays(pf)
    b = np.full(12, 20.0 / 12, np.float32)
    f = np.linspace(0.3, 1.9, 12).astype(np.float32)
    want = ref_w.round_totals(ra, jnp.asarray(b), jnp.asarray(f))
    got = w.round_totals(pa, torch.tensor(b), torch.tensor(f))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
