"""The port's wireless scenario (``repro_torch.api.scenario``) against the
reference's (``repro.api.scenario``), on the CPU.

* Specs: ``FleetSpec``/``CellSpec`` validation and their JSON round trip;
  the port's ``ExperimentSpec(fleet=…, compressor=…).to_dict()`` equals
  the reference's on every field the port has (the rest are the
  reference's fields the port refuses, at their defaults).
* Fleet construction: ``build_fleet`` is host numpy on both sides, so
  every field is equal (``assert_array_equal``), for each built-in
  channel; ``FleetSpec()`` equals ``sample_fleet``; ``cell_fleet``,
  ``select``, ``with_power`` and ``fleet_arrays`` (fp32 ``xgain``) too.
* Channels: each channel's step on the reference's CN(0,1) draws gives
  the reference's J within rtol 1e-6; ``gauss-markov:0`` equals
  ``rayleigh-block`` bit for bit; |h|² is unit-mean with lag-1
  correlation ρ² (fixed seed, 20,000 devices: mean within 0.03,
  correlation within 0.03).
* Allocators under interference: ``inr`` is folded exactly once — an
  allocation of ``arr`` with ``inr`` equals the port's own allocation of
  ``J / (1 + inr)`` without it bit for bit — and the port matches the
  reference within each allocator's band (SAO rtol 2e-3, equal bandwidth
  1e-5, FEDL 1e-2).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ALLOCATORS as REF_ALLOCATORS
from repro.api import ExperimentSpec as RefSpec
from repro.api import scenario as ref_sc
from repro.core.wireless import fleet_arrays as ref_fleet_arrays
from repro.core.wireless import sample_fleet as ref_sample_fleet

from repro_torch.api import ALLOCATORS, ExperimentSpec
from repro_torch.api import scenario as sc
from repro_torch.api.registry import CHANNELS, StrategyError
from repro_torch.core.draws import TorchDraws
from repro_torch.core.wireless import (effective_arrays, fleet_arrays,
                                       sample_fleet)

DYNAMIC = {"name": "multicell-dynamic", "params": {"rho": 0.9}}
FIELDS = ("h", "p", "z", "C", "D", "alpha", "f_min", "f_max", "e_cons",
          "cell", "inr")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def test_fleetspec_json_roundtrip_and_validation():
    fs = sc.FleetSpec(cells=(sc.CellSpec(devices=5, center_km=(0, 0)),
                             {"devices": 7, "p_dbm": 20.0}),
                      channel="multicell-interference:0.5")
    assert fs.num_cells == 2 and isinstance(fs.cells[1], sc.CellSpec)
    assert fs.channel == {"name": "multicell-interference",
                          "params": {"load": 0.5, "shadow_db": 8.0}}
    assert sc.FleetSpec.from_json(fs.to_json()) == fs
    assert fs.centers_km() == [(0.0, 0.0), (0.6, 0.0)]
    with pytest.raises(ValueError, match="at least one cell"):
        sc.FleetSpec(cells=())
    with pytest.raises(ValueError, match="newer"):
        sc.FleetSpec.from_dict({"version": 9})
    with pytest.raises(ValueError, match="unknown FleetSpec fields"):
        sc.FleetSpec.from_dict({"nope": 1})
    with pytest.raises(ValueError, match="pair"):
        sc.CellSpec(e_cons_range=3.0)
    with pytest.raises(ValueError, match="devices is unset"):
        sc.CellSpec().resolved_devices(None)
    with pytest.raises(ValueError, match="rho"):
        CHANNELS.resolve("gauss-markov:1.5")
    with pytest.raises(StrategyError, match="floor"):
        CHANNELS.resolve("rayleigh-block:x")
    rb = CHANNELS.resolve("rayleigh-block:0.01")
    assert rb.rho == 0.0 and rb.floor == 0.01 and "rho" not in rb.params()


@pytest.mark.parametrize("fleet,compressor", [
    (None, "int8"),
    (lambda m: m.multicell_fleet_spec(2, channel=DYNAMIC), "topk:0.05"),
    (lambda m: m.FleetSpec(channel="gauss-markov:0.9"), "none"),
    (lambda m: m.multicell_fleet_spec(3), "int8")])
def test_spec_to_dict_equals_the_reference(fleet, compressor):
    kw = dict(compressor=compressor, aggregator="fedavgm:0.9")
    port = ExperimentSpec(**kw, fleet=None if fleet is None else fleet(sc))
    ref = RefSpec(**kw, fleet=None if fleet is None else fleet(ref_sc))
    got, want = port.to_dict(), ref.to_dict()
    assert {k: want[k] for k in got} == got
    assert set(want) == set(got)
    assert ExperimentSpec.from_json(port.to_json()) == port
    assert port.num_cells == ref.num_cells
    assert (port.resolved_fleet_spec.to_dict()
            == ref.resolved_fleet_spec.to_dict())


# ---------------------------------------------------------------------------
# fleet construction
# ---------------------------------------------------------------------------


def _assert_fleets_equal(port, ref):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (port.L, port.N0, port.num_cells) == (ref.L, ref.N0,
                                                 ref.num_cells)
    if ref.xgain is None:
        assert port.xgain is None
    else:
        np.testing.assert_array_equal(port.xgain, ref.xgain)


@pytest.mark.parametrize("cells,channel", [
    (1, "static"), (1, "gauss-markov:0.9"), (1, "rayleigh-block"),
    (3, "multicell-interference"), (2, DYNAMIC), (2, "multicell-dynamic")])
def test_build_fleet_equals_the_reference(cells, channel):
    port = sc.build_fleet(sc.multicell_fleet_spec(cells, channel=channel),
                          seed=4, clients=12, bandwidth_mhz=10.0)
    ref = ref_sc.build_fleet(
        ref_sc.multicell_fleet_spec(cells, channel=channel), seed=4,
        clients=12, bandwidth_mhz=10.0)
    _assert_fleets_equal(port, ref)
    if channel == "multicell-interference":
        assert np.all(port.inr > 0)
    for c in range(cells):
        _assert_fleets_equal(port.cell_fleet(c), ref.cell_fleet(c))
    idx = np.array([5, 0, 7])
    _assert_fleets_equal(port.select(idx), ref.select(idx))
    p_new = np.linspace(0.05, 0.2, port.num_devices)
    _assert_fleets_equal(port.with_power(p_new), ref.with_power(p_new))
    got, want = fleet_arrays(port), ref_fleet_arrays(ref)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        assert got[k].dtype == torch.float32


def test_default_fleetspec_is_sample_fleet_and_xgain_scales_with_power():
    _assert_fleets_equal(sc.build_fleet(sc.FleetSpec(), seed=3, clients=9),
                         sample_fleet(9, seed=3))
    _assert_fleets_equal(sample_fleet(9, seed=3), ref_sample_fleet(9, seed=3))
    fl = sc.build_fleet(sc.multicell_fleet_spec(2, channel=DYNAMIC), seed=1,
                        clients=4)
    half = fl.with_power(fl.p / 2)
    np.testing.assert_allclose(half.xgain, fl.xgain / 2, rtol=1e-15)
    assert fl.xgain.shape == (8, 2) and np.all(fl.xgain[fl.cell == 0, 0] == 0)
    lanes = fleet_arrays([fl.cell_fleet(0), fl.cell_fleet(1)])
    assert lanes["xgain"].shape == (2, 4, 2)


# ---------------------------------------------------------------------------
# channels
# ---------------------------------------------------------------------------


def _ref_draw(key, shape):
    """The CN(0,1) draw the reference's ``_gm_init``/``_gm_step`` make."""
    return torch.tensor(np.asarray(jax.random.normal(
        key, shape + (2,), jnp.float32) * float(np.sqrt(0.5))))


@pytest.mark.parametrize("channel", [
    "gauss-markov:0.9", "gauss-markov:0", "rayleigh-block:0.01", DYNAMIC,
    "static", "multicell-interference"])
def test_channel_steps_on_the_reference_draws(channel):
    port, ref = CHANNELS.resolve(channel), ref_sc.CHANNELS.resolve(channel)
    rng = np.random.default_rng(0)
    J = rng.uniform(0.5, 4e3, 64).astype(np.float32)
    arr_p, arr_r = {"J": torch.tensor(J)}, {"J": jnp.asarray(J)}
    if not port.stateful:
        assert port.apply_traced(None, arr_p) is arr_p
        assert not ref.stateful and not port.needs_rng
        return
    k0 = jax.random.PRNGKey(7)
    h_r = ref.init_state(k0, arr_r)
    h_p = port.init_state(_ref_draw(k0, (64,)), arr_p)
    np.testing.assert_array_equal(h_p.numpy(), np.asarray(h_r))
    for i in range(4):
        k = jax.random.PRNGKey(100 + i)
        h_r, out_r = ref.step_traced(k, h_r, arr_r)
        h_p, out_p = port.step_traced(_ref_draw(k, (64,)), h_p, arr_p)
        np.testing.assert_allclose(out_p["J"].numpy(),
                                   np.asarray(out_r["J"]), rtol=1e-6)
        np.testing.assert_allclose(h_p.numpy(), np.asarray(h_r), rtol=1e-6,
                                   atol=1e-7)


def test_gauss_markov_zero_is_rayleigh_block_bit_for_bit():
    gm, rb = CHANNELS.resolve("gauss-markov:0"), CHANNELS.resolve(
        "rayleigh-block")
    arr = {"J": torch.rand(50, generator=torch.Generator().manual_seed(0))}
    out = []
    for ch in (gm, rb):
        d = TorchDraws(3, "cpu")
        h = ch.init_state(d.channel_init((50,)), arr)
        js = []
        for _ in range(5):
            h, a = ch.step_traced(d.channel_step((50,)), h, arr)
            js.append(a["J"])
        out.append(torch.stack(js))
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("rho", [0.9, 0.0])
def test_fade_is_unit_mean_with_rho_squared_correlation(rho):
    n = 20_000
    arr = {"J": torch.ones(n)}
    ch = CHANNELS.resolve({"name": "gauss-markov",
                           "params": {"rho": rho, "floor": 0.0}})
    d = TorchDraws(0, "cpu")
    h = ch.init_state(d.channel_init((n,)), arr)
    gains = []
    for _ in range(6):
        h, out = ch.step_traced(d.channel_step((n,)), h, arr)
        gains.append(out["J"].numpy().astype(np.float64))
    for g in gains:
        assert abs(g.mean() - 1.0) < 0.03
    corr = np.mean([np.corrcoef(a, b)[0, 1]
                    for a, b in zip(gains, gains[1:])])
    assert abs(corr - rho ** 2) < 0.03


# ---------------------------------------------------------------------------
# allocators under interference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,rtol", [("sao", 2e-3), ("equal", 1e-5),
                                       ("fedl:1.0", 1e-2),
                                       ("fedl_auto:6", 1e-2)])
def test_inr_is_folded_exactly_once(name, rtol):
    fleet = sc.build_fleet(sc.multicell_fleet_spec(3), seed=2, clients=5)
    ref_fleet = ref_sc.build_fleet(ref_sc.multicell_fleet_spec(3), seed=2,
                                   clients=5)
    idx = np.array([0, 3, 6, 9, 12, 14])
    arr = fleet_arrays(fleet.select(idx))
    assert float(torch.min(arr["inr"])) > 0
    folded = effective_arrays(arr)
    assert "inr" not in folded and effective_arrays(folded) is folded
    got = ALLOCATORS.resolve(name).allocate(arr, 20.0)
    once = ALLOCATORS.resolve(name).allocate(folded, 20.0)
    assert torch.equal(got.T, once.T) and torch.equal(got.E, once.E)
    want = REF_ALLOCATORS.resolve(name).allocate(
        ref_fleet_arrays(ref_fleet.select(idx)), 20.0)
    np.testing.assert_allclose(float(got.T), float(want.T), rtol=rtol)
    np.testing.assert_allclose(float(got.E), float(want.E), rtol=rtol)
    clean = ALLOCATORS.resolve(name).allocate(
        dict(arr, inr=torch.zeros_like(arr["inr"])), 20.0)
    assert float(got.T) > float(clean.T)        # interference costs time
