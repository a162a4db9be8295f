"""The port's data, fleet and SAO against the reference: numpy copies are
byte-identical, the fp32 solver agrees within the outer bisection's band
(eps0 = 1e-3), and the Theorem-1 conditions hold on the port."""
import torch_threads  # noqa: F401  (first: one torch thread)
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sao as ref_sao
from repro.core import wireless as ref_wireless
from repro.data.partition import partition_bias as ref_partition_bias
from repro.data.synthetic import make_dataset as ref_make_dataset

from repro_torch.core import wireless
from repro_torch.core.sao import _Q, kkt_residuals, solve_sao
from repro_torch.core.wireless import LN2, fleet_arrays, sample_fleet
from repro_torch.data.partition import partition_bias
from repro_torch.data.synthetic import make_dataset

B_MHZ = 20.0
FLEET_FIELDS = ("h", "p", "z", "C", "D", "L", "alpha", "f_min", "f_max",
                "e_cons", "N0", "inr")


@pytest.mark.parametrize("name", ["mnist", "fashion", "cifar10"])
def test_make_dataset_byte_identical(name):
    got = make_dataset(name, 24, seed=5)
    want = ref_make_dataset(name, 24, seed=5)
    assert np.array_equal(got.images, want.images)
    assert got.images.dtype == want.images.dtype
    assert np.array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype
    assert got.num_classes == want.num_classes


@pytest.mark.parametrize("sigma", [0.8, 0.5, "H"])
def test_partition_bias_byte_identical(sigma):
    ds = make_dataset("fashion", 200, seed=0)
    got = partition_bias(ds, 12, 10, sigma, seed=3)
    want = ref_partition_bias(ref_make_dataset("fashion", 200, seed=0), 12,
                              10, sigma, seed=3)
    for field in ("images", "labels", "majority", "sizes"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype


@pytest.mark.parametrize("n,seed", [(40, 0), (100, 7)])
def test_sample_fleet_byte_identical(n, seed):
    got = sample_fleet(n, seed=seed)
    want = ref_wireless.sample_fleet(n, seed=seed)
    for field in FLEET_FIELDS:
        assert np.array_equal(np.asarray(getattr(got, field)),
                              np.asarray(getattr(want, field))), field
    sel = np.array([3, 1, 7])
    got_arr = fleet_arrays(got.select(sel))
    want_arr = ref_wireless.fleet_arrays(want.select(sel))
    for k, v in got_arr.items():
        assert v.dtype == torch.float32
        assert np.array_equal(v.numpy(), np.asarray(want_arr[k])), k


def test_delay_energy_model_matches_reference():
    """Eqs. (5)-(9), the interference fold and the masked reductions."""
    arr, ref_arr = _arrs(1, 6)
    rng = np.random.default_rng(0)
    b = rng.uniform(0.5, 5.0, 6).astype(np.float32)
    f = rng.uniform(0.2, 2.0, 6).astype(np.float32)
    mask = np.array([True, True, False, True, False, True])
    inr = rng.uniform(0.0, 2.0, 6).astype(np.float32)
    arr["inr"], ref_arr["inr"] = torch.tensor(inr), jnp.asarray(inr)
    tb, tf, tm = torch.tensor(b), torch.tensor(f), torch.tensor(mask)
    for name, args in (("rate_mbps", ("b", "J")), ("t_cmp", ("U", "f")),
                       ("e_cmp", ("G", "f")), ("t_com", ("z", "b", "J")),
                       ("e_com", ("H", "b", "J"))):
        got = getattr(wireless, name)(*[
            {"b": tb, "f": tf}.get(a, arr.get(a)) for a in args])
        want = getattr(ref_wireless, name)(*[
            {"b": b, "f": f}.get(a, ref_arr.get(a)) for a in args])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   err_msg=name)
    got = wireless.completion_times(arr, tb, tf, tm).numpy()
    want = np.asarray(ref_wireless.completion_times(ref_arr, b, f,
                                                    jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all(np.isinf(got[~mask]))
    x = torch.tensor(b)
    assert float(wireless.masked_max(x, tm)) == float(
        ref_wireless.masked_max(jnp.asarray(b), jnp.asarray(mask)))
    np.testing.assert_allclose(
        float(wireless.masked_sum(x, tm)),
        float(ref_wireless.masked_sum(jnp.asarray(b), jnp.asarray(mask))),
        rtol=1e-6)
    assert float(wireless.masked_max(x, torch.zeros(6, dtype=torch.bool),
                                     empty=-1.0)) == -1.0


def _arrs(seed, n):
    fleet = sample_fleet(100, seed=seed)
    sel = np.arange(n)
    ref_fleet = ref_wireless.sample_fleet(100, seed=seed)
    return (fleet_arrays(fleet.select(sel)),
            ref_wireless.fleet_arrays(ref_fleet.select(sel)))


@pytest.mark.parametrize("seed,n", [(0, 10), (3, 10), (11, 40), (5, 4),
                                    (9, 10)])
def test_solve_sao_matches_reference(seed, n):
    """seed 9 is an infeasible draw: neither solver converges."""
    arr, ref_arr = _arrs(seed, n)
    got = solve_sao(arr, B_MHZ)
    want = ref_sao.solve_sao(ref_arr, B_MHZ)
    np.testing.assert_allclose(float(got.T), float(want.T), rtol=2e-3)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=2e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f), rtol=2e-3,
                               atol=1e-5)
    assert bool(got.converged) == bool(want.converged)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _default_fleet_sets():
    """The all-device set of the default spec's initial round, then four
    10-device sets: the first two are infeasible at B = 20 MHz, the last
    two feasible."""
    rng = np.random.default_rng(0)
    return [np.arange(40)] + [np.sort(rng.choice(40, 10, replace=False))
                              for _ in range(4)]


@pytest.mark.parametrize("k", range(5))
def test_solve_sao_default_fleet_matches_reference(k):
    """The default spec's fleet (``sample_fleet(40, seed=0)``) has sets
    that no allocation within B fits. Both solvers flag the same sets with
    the same band use, and ``chip_smoke.least_band_mhz`` (energy budgets
    met at f_min, apart from the solver) predicts the flag and the flagged
    band use."""
    sel = _default_fleet_sets()[k]
    fleet = sample_fleet(40, seed=0)
    ref_fleet = ref_wireless.sample_fleet(40, seed=0)
    got = solve_sao(fleet_arrays(fleet.select(sel)), B_MHZ)
    want = ref_sao.solve_sao(ref_wireless.fleet_arrays(ref_fleet.select(sel)),
                             B_MHZ)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(float(torch.sum(got.b)),
                               float(jnp.sum(want.b)), rtol=2e-3)
    np.testing.assert_allclose(float(got.T), float(want.T), rtol=2e-3)
    least = float(_chip_smoke().least_band_mhz(fleet)[sel].sum())
    assert bool(want.converged) == (least <= B_MHZ)
    assert bool(want.converged) == (k >= 3)
    if not bool(want.converged):
        np.testing.assert_allclose(float(jnp.sum(want.b)), least, rtol=1e-4)
    else:
        assert float(torch.sum(got.b)) <= B_MHZ * (1.0 + 1e-4)


def test_solve_sao_masked_lanes_match_reference():
    arr, ref_arr = _arrs(2, 10)
    mask = np.array([True] * 7 + [False] * 3)
    got = solve_sao(arr, B_MHZ, mask=torch.tensor(mask))
    want = ref_sao.solve_sao(ref_arr, B_MHZ, mask=jnp.asarray(mask))
    np.testing.assert_allclose(float(got.T), float(want.T), rtol=2e-3)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=2e-3,
                               atol=1e-5)
    assert np.all(got.b.numpy()[~mask] == 0.0)
    assert np.all(got.f.numpy()[~mask] == 0.0)


@pytest.mark.parametrize("seed", [0, 1, 4, 12, 16])
def test_sao_theorem1_conditions(seed):
    """The ``test_sao.py`` checks, on the port: feasibility (19a)-(19d),
    equal delays (20) and tight energy (21) for interior devices."""
    arr, _ = _arrs(seed, 10)
    sol = solve_sao(arr, B_MHZ)
    assert bool(sol.converged)
    r = kkt_residuals(sol, arr, B_MHZ)
    assert float(torch.max(-r["energy_slack"])) < 1e-4
    assert float(torch.sum(sol.b)) <= B_MHZ * (1.0 + 1e-4)
    assert bool(torch.all(sol.f >= arr["f_min"] - 1e-6))
    assert bool(torch.all(sol.f <= arr["f_max"] + 1e-6))
    assert abs(float(torch.max(r["t"]) - sol.T)) < 1e-5
    interior = ((sol.f > arr["f_min"] + 1e-4)
                & (sol.f < arr["f_max"] - 1e-4)).numpy()
    t = r["t"].numpy()
    if interior.sum() >= 2:
        assert t[interior].max() - t[interior].min() < 0.05 * float(sol.T)
    if interior.any():
        assert r["energy_slack"].numpy()[interior].max() < 5e-4


def test_sao_monotone_in_bandwidth():
    arr, _ = _arrs(6, 10)
    t_wide, t_narrow = solve_sao(arr, 30.0).T, solve_sao(arr, 15.0).T
    assert float(t_wide) <= float(t_narrow) * 1.02


def test_lemma2_Q_monotone_bounded():
    J = torch.tensor([5.0, 50.0, 500.0])
    b = torch.linspace(0.01, 100.0, 200)[:, None]
    q = _Q(b, J[None, :])
    assert bool(torch.all(torch.diff(q, dim=0) > -1e-6))
    assert bool(torch.all(q < J[None, :] / LN2))
