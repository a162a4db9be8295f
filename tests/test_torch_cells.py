"""The wireless scenario end to end on the CPU: fading channels in the
device-resident run, FedAvgM and the uplink compressors in the round
body, and multi-cell cohorts (``build_cohort`` with a ``FleetSpec`` of
cells: lane ``seed·cells + cell``) — against the reference, each lane
replaying its seed's ``jax.random`` key stream (``JaxReplayDraws``, the
fade's draws included), and against the port's own single runs.

Tolerances against the reference: selections equal, T_k/E_k rtol 2e-3,
accuracy within one test sample, a dynamic cohort's ``inr`` rtol 1e-5,
the global row and the client plane atol 1e-4 — under ``int8``, except
the entries an int8 rounding flipped (at most 0.1 % of them, each within
1e-3): the two packages' trained rows agree to ~1e-7, and such a drift
moves a value across a rounding boundary of the int8 grid now and then,
which changes it by one quantization step (max|Δ|/127 of its leaf, here
≈ 1e-4). The port against itself (a static cell lane against its
``build_experiment(spec, cell=c)`` run): selections and accuracy equal,
T_k/E_k rtol 1e-6, rows atol 1e-6.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as RefSpec
from repro.api import build_cohort as ref_build_cohort
from repro.api import build_experiment as ref_build_experiment
from repro.api import scenario as ref_sc
from repro.utils.trees import tree_flatten_vector

from repro_torch.api import ExperimentSpec, build_cohort, build_experiment
from repro_torch.api import scenario as sc
from repro_torch.core.cohort import CohortHistory

from test_torch_slice import JaxReplayDraws

TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=3, devices_per_round=4, num_clusters=4,
            learning_rate=0.05)
MOMENTUM_INT8 = dict(TINY, aggregator="fedavgm:0.9", compressor="int8")
DYNAMIC = {"name": "multicell-dynamic", "params": {"rho": 0.9}}
ACC = 1.0 / TINY["test_samples"] + 1e-6


def _rows_close(got, want, int8):
    got, want = np.asarray(got), np.asarray(want)
    if not int8:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        return
    off = np.abs(got - want) > 1e-4
    assert off.sum() <= 1e-3 * got.size, off.sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fading_runs():
    """A single-cell ``gauss-markov:0.9`` traced run with ``fedavgm:0.9``
    and ``int8``, on both sides."""
    fleet = dict(channel="gauss-markov:0.9")
    ref = ref_build_experiment(RefSpec(**MOMENTUM_INT8,
                                       fleet=ref_sc.FleetSpec(**fleet)))
    port = build_experiment(ExperimentSpec(**MOMENTUM_INT8,
                                           fleet=sc.FleetSpec(**fleet)),
                            device="cpu", draws=JaxReplayDraws(0))
    return ref, ref.run(), port, port.run()


def test_fading_run_matches_the_reference(fading_runs):
    ref, h_ref, port, h = fading_runs
    assert h.seconds == []                         # the traced path ran
    for a, b in zip(h.selected, h_ref.selected):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(h.T_k, h_ref.T_k, rtol=2e-3)
    np.testing.assert_allclose(h.E_k, h_ref.E_k, rtol=2e-3)
    np.testing.assert_allclose(h.accuracy, h_ref.accuracy, rtol=0, atol=ACC)
    _rows_close(port.global_vec.numpy(),
                tree_flatten_vector(ref.global_params), int8=True)
    _rows_close(port.client_plane.numpy(), ref.client_params, int8=True)
    np.testing.assert_allclose(
        port.aggregator.init_flat_state(port.global_vec).numpy(),
        np.asarray(tree_flatten_vector(ref.aggregator._opt.v)), atol=1e-3)
    z = port.fleet.z
    assert np.all(z == np.asarray(ref.fleet.z)) and z[0] < 448 * 8 / 1e3


def _cohort_pair(kw, fleet):
    ref_runner = ref_build_cohort(RefSpec(**kw, cohort=1,
                                          fleet=fleet(ref_sc)))
    port_runner = build_cohort(ExperimentSpec(**kw, cohort=1,
                                              fleet=fleet(sc)),
                               device="cpu", draws=JaxReplayDraws)
    return ref_runner, ref_runner.run(), port_runner, port_runner.run()


COHORTS = {
    "dynamic-rho": (MOMENTUM_INT8,
                    lambda m: m.multicell_fleet_spec(2, channel=DYNAMIC)),
    "dynamic": (MOMENTUM_INT8, lambda m: m.multicell_fleet_spec(
        2, channel="multicell-dynamic")),
    "static": (TINY, lambda m: m.multicell_fleet_spec(2)),
}


@pytest.fixture(scope="module")
def cohort_runs():
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = _cohort_pair(*COHORTS[name])
        return runs[name]
    return get


@pytest.mark.parametrize("name", sorted(COHORTS))
def test_cell_cohort_matches_the_reference(name, cohort_runs):
    ref_runner, ref_ch, runner, ch = cohort_runs(name)
    assert ch.seeds == list(ref_ch.seeds) == [0, 0]
    assert ch.cells == ref_ch.cells == 2 and ch.lane_cells == [0, 1]
    np.testing.assert_array_equal(ch.mask, np.asarray(ref_ch.mask))
    for i in range(len(ch)):
        for a, b in zip(ch.history(i).selected, ref_ch.history(i).selected):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(ch.T_k, np.asarray(ref_ch.T_k), rtol=2e-3)
    np.testing.assert_allclose(ch.E_k, np.asarray(ref_ch.E_k), rtol=2e-3)
    np.testing.assert_allclose(ch.accuracy, np.asarray(ref_ch.accuracy),
                               rtol=0, atol=ACC)
    int8 = COHORTS[name][0] is MOMENTUM_INT8
    for r, p in zip(ref_runner.experiments, runner.experiments):
        _rows_close(p.global_vec.numpy(),
                    tree_flatten_vector(r.global_params), int8)
        _rows_close(p.client_plane.numpy(), r.client_params, int8)
        np.testing.assert_array_equal(p.cluster_labels,
                                      np.asarray(r.cluster_labels))
    if name == "static":
        assert ch.inr is None and ref_ch.inr is None
    else:
        assert ch.inr.shape == (2, TINY["rounds"])
        np.testing.assert_allclose(ch.inr, np.asarray(ref_ch.inr), rtol=1e-5)
        assert np.all(ch.inr > 0)


def test_dynamic_interference_follows_the_selections(cohort_runs):
    """Each lane's ``inr`` is the cross gains of the devices the other
    cell selected, recomputed on the host from the history."""
    _, _, runner, ch = cohort_runs("dynamic")
    xg = [e.fleet.xgain for e in runner.experiments]
    for k in range(TINY["rounds"]):
        for c in range(2):
            other = 1 - c
            sel = ch.selected[other, k][ch.mask[other, k]]
            want = float(np.sum(xg[other][sel, c]))
            np.testing.assert_allclose(ch.inr[c, k], want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


def test_static_cell_lanes_equal_their_single_runs(cohort_runs):
    _, _, runner, ch = cohort_runs("static")
    spec = runner.spec
    for c in range(2):
        single = build_experiment(spec, device="cpu", cell=c,
                                  draws=JaxReplayDraws(0))
        h = single.run()
        hi = ch.history(c)
        for a, b in zip(hi.selected, h.selected):
            np.testing.assert_array_equal(a, b)
        assert hi.accuracy == h.accuracy
        np.testing.assert_allclose(hi.T_k, h.T_k, rtol=1e-6)
        np.testing.assert_allclose(hi.E_k, h.E_k, rtol=1e-6)
        lane = runner.experiments[c]
        np.testing.assert_allclose(lane.global_vec.numpy(),
                                   single.global_vec.numpy(), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(lane.client_plane.numpy(),
                                   single.client_plane.numpy(), atol=1e-6,
                                   rtol=0)
        assert np.all(single.fleet.inr > 0) and single.cell == c


def test_cells_partition_from_their_own_streams():
    spec = ExperimentSpec(**TINY, fleet=sc.multicell_fleet_spec(2))
    a, b = (build_experiment(spec, device="cpu", cell=c) for c in (0, 1))
    assert not np.array_equal(a.fed.images, b.fed.images)
    np.testing.assert_array_equal(a.test_images.numpy(),
                                  b.test_images.numpy())
    own = build_experiment(spec, device="cpu",
                           test_data=(a.test_images.numpy()[:8],
                                      a.test_labels.numpy()[:8]))
    assert own.test_images.shape[0] == 8
    with pytest.raises(ValueError, match="out of range"):
        build_experiment(spec, device="cpu", cell=2)
    with pytest.raises(ValueError, match="multi-cell FleetSpec"):
        build_experiment(ExperimentSpec(**TINY), device="cpu", cell=1)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_single_cell_view_of_a_dynamic_fleet_names_the_cohort_runner():
    spec = ExperimentSpec(**TINY, fleet=sc.multicell_fleet_spec(
        2, channel="multicell-dynamic"))
    exp = build_experiment(spec, device="cpu", cell=1)
    with pytest.raises(ValueError, match="CohortRunner"):
        exp.run()
    with pytest.raises(ValueError, match="CohortRunner"):
        exp._run_host(None, 1, 0.0)


def test_fading_channel_refuses_the_host_loop():
    spec = ExperimentSpec(**TINY, fleet=sc.FleetSpec(channel="rayleigh-block"),
                          target_accuracy=0.99)
    with pytest.raises(ValueError, match="no host-loop equivalent"):
        build_experiment(spec, device="cpu").run()


def test_unequal_cells_refuse_a_cohort():
    fleet = sc.FleetSpec(cells=(sc.CellSpec(devices=8), sc.CellSpec(devices=6)),
                         channel="multicell-interference")
    spec = ExperimentSpec(**dict(TINY, clients=8), fleet=fleet)
    with pytest.raises(ValueError, match="equal device counts"):
        build_cohort(spec, device="cpu").run()


@pytest.mark.parametrize("value", ["trimmed:0.2", "clipnorm:1.0",
                                   "trimmed"])
def test_unported_aggregators_name_the_port(value):
    """Once refused (naming the port), the robust folds are ported: the
    spec stores the reference's canonical form, and the fold of the same
    rows (one NaN lane at weight 0) agrees with the reference's."""
    from repro.api.registry import AGGREGATORS as REF_AGGREGATORS
    from repro_torch.api.registry import AGGREGATORS
    spec = ExperimentSpec(aggregator=value)
    assert spec.aggregator == RefSpec(aggregator=value).aggregator
    rng = np.random.default_rng(0)
    g = rng.normal(scale=0.1, size=16).astype(np.float32)
    rows = (g + rng.normal(scale=0.1, size=(5, 16))).astype(np.float32)
    w = np.asarray([1.0, 2.0, 0.0, 1.5, 3.0], np.float32)
    rows[2] = np.nan
    got, _ = AGGREGATORS.resolve(spec.aggregator).aggregate_flat(
        torch.tensor(g), torch.tensor(rows), torch.tensor(w), None)
    want, _ = REF_AGGREGATORS.resolve(spec.aggregator).aggregate_flat(
        g, rows, w, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("field,value", [
    ("p_shards", 2), ("faults", "outage:0.1"), ("quarantine_after", 2)])
def test_unported_fields_name_the_port(field, value):
    """``p_shards``, ``faults`` and ``quarantine_after``, once refused
    with a ``TypeError`` naming the port, are ported: their JSON form is
    the reference's and round trips."""
    spec = ExperimentSpec(**{field: value})
    assert spec.to_dict()[field] == RefSpec(**{field: value}).to_dict()[field]
    assert ExperimentSpec.from_dict({field: value}) == spec
    assert ExperimentSpec.from_json(spec.to_json()) == spec


def test_churn_on_the_dense_store_is_refused():
    """Churn is a field of the port's spec; as in the reference, it needs
    the paged store or an asynchronous aggregator (``fedbuff``) to track
    availability."""
    spec = ExperimentSpec(**TINY, churn_leave=0.1)
    assert ExperimentSpec.from_dict(spec.to_dict()) == spec
    with pytest.raises(ValueError, match="churn.*store='paged'"):
        build_experiment(spec, device="cpu")


def test_cohort_history_carries_cells_and_inr():
    ch = CohortHistory(seeds=[3, 3, 4, 4], accuracy=np.zeros((4, 2)),
                       T_k=np.zeros((4, 2)), E_k=np.zeros((4, 2)),
                       selected=np.zeros((4, 1, 2), np.int64),
                       mask=np.ones((4, 1, 2), bool), with_init=True,
                       num_devices=5, cells=2, inr=np.ones((4, 1)))
    assert ch.lane_cells == [0, 1, 0, 1] and ch.inr.shape == (4, 1)
