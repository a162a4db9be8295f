"""The port's buffered-asynchronous engine (``core/async_engine.py``) on
the dense store, on the CPU, where the tick runs eagerly (on the card: one
captured tick, replayed).

(a) ``fedbuff`` resolution, validation and the spec's JSON round trip;
    ``parse_churn``; ``completion_times``' +inf padding; the staleness
    weights' properties (Hypothesis, as the reference's suite);
(b) the port's dense asynchronous run against the reference's
    ``build_experiment(spec).run()``, replaying its key stream
    (``FaultReplayDraws``, with its churn split and its fault masks at
    dispatch), with and without churn, and under faults, byzantine
    clients and quarantine with churn: dispatches, participation and
    active counts equal, staleness rtol 1e-6, T_k/E_k rtol 2e-3, the
    global row atol 1e-4, accuracy within one test sample, the fault and
    strike counts equal;
(c) the degenerate pin (``fedbuff:M>=S_pad:0``, no churn ≡ the synchronous
    traced run, bit for bit, port against port), the empty fire as a
    no-op, churn never dispatching an unavailable client, the virtual
    clock continuing across ``run()`` calls;
(d) a 2-lane cohort's traces, each lane its seed's single run;
(e) the refusals.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as RefSpec
from repro.api import build_experiment as ref_build_experiment
from repro.core.wireless import completion_times as ref_completion_times
from repro.core.wireless import fleet_arrays as ref_fleet_arrays
from repro.core.wireless import sample_fleet as ref_sample_fleet
from repro.utils.trees import tree_flatten_vector

from repro_torch.api import (AGGREGATORS, ExperimentSpec, StrategyError,
                             build_cohort, build_experiment)
from repro_torch.core import engine
from repro_torch.core.async_engine import parse_churn
from repro_torch.core.store import ClientStats
from repro_torch.core.wireless import (completion_times, fleet_arrays,
                                       sample_fleet)
from tests.hypothesis_compat import given, settings, st

from test_torch_slice import FaultReplayDraws

TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=3, devices_per_round=4, num_clusters=4,
            learning_rate=0.05)
CHURN = dict(churn_leave=0.3, churn_join=0.3)
FAULTS = dict(faults="outage:0.2,corrupt:0.3,byzantine:0.2",
              quarantine_after=2, churn_leave=0.05, churn_join=0.1)


# ---------------------------------------------------------------------------
# (a) the aggregator, the spec, the helpers
# ---------------------------------------------------------------------------


def test_fedbuff_resolves_and_validates():
    agg = AGGREGATORS.resolve("fedbuff:4:0.5")
    assert (agg.m, agg.alpha) == (4, 0.5)
    assert agg.async_capable and agg.traceable and not agg.fuses_with_engine
    assert agg.buffer_size == 4 and agg.staleness_alpha == 0.5
    assert AGGREGATORS.resolve("fedbuff:3").alpha == 0.0
    assert AGGREGATORS.resolve("fedbuff").m == 10
    assert agg.init_flat_state(torch.zeros(3)) is None
    with pytest.raises(StrategyError, match=">= 1"):
        AGGREGATORS.resolve("fedbuff:0")
    with pytest.raises(StrategyError, match=">= 0"):
        AGGREGATORS.resolve("fedbuff:4:-1")
    with pytest.raises(StrategyError, match="M"):
        AGGREGATORS.resolve("fedbuff:x")
    assert not getattr(AGGREGATORS.resolve("fedavg"), "async_capable", False)


def test_fedbuff_fold_is_fedavgs():
    """``aggregate_flat`` is FedAvg's one row reduction, bit for bit."""
    rng = np.random.default_rng(0)
    rows = torch.tensor(rng.normal(size=(4, 33)).astype(np.float32))
    w = torch.tensor([1.0, 0.0, 2.0, 0.5])
    got, state = AGGREGATORS.resolve("fedbuff:4").aggregate_flat(
        torch.zeros(33), rows, w, None)
    want, _ = AGGREGATORS.resolve("fedavg").aggregate_flat(
        torch.zeros(33), rows, w, None)
    assert state is None and torch.equal(got, want)


def test_fedbuff_spec_round_trip():
    spec = ExperimentSpec(**TINY, aggregator="fedbuff:4:0.5",
                          churn_leave=0.1, churn_join=0.2)
    back = ExperimentSpec.from_json(spec.to_json())
    assert back == spec
    assert back.aggregator == {"name": "fedbuff",
                               "params": {"m": 4, "alpha": 0.5}}
    assert (back.churn_leave, back.churn_join) == (0.1, 0.2)
    ref = RefSpec(**TINY, aggregator="fedbuff:4:0.5", churn_leave=0.1,
                  churn_join=0.2)
    assert ref.aggregator == back.aggregator


def test_parse_churn():
    assert parse_churn(None) == (0.0, 0.0)
    assert parse_churn("0.3") == (0.3, 0.0)
    assert parse_churn("0.3:0.1") == (0.3, 0.1)
    assert parse_churn((0.2, 0.4)) == (0.2, 0.4)
    assert parse_churn(0.5) == (0.5, 0.0)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        parse_churn("1.5")
    with pytest.raises(ValueError, match="numeric"):
        parse_churn("often")
    with pytest.raises(ValueError):
        parse_churn((0.1, 0.2, 0.3))


def test_completion_times_mask_to_inf():
    arr = fleet_arrays(sample_fleet(4, seed=0))
    b, f = torch.full((4,), 5.0), torch.full((4,), 1.0)
    d = completion_times(arr, b, f)
    assert torch.isfinite(d).all() and (d > 0).all()
    want = np.asarray(ref_completion_times(
        ref_fleet_arrays(ref_sample_fleet(4, seed=0)), jnp.full((4,), 5.0),
        jnp.full((4,), 1.0)))
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-6)
    mask = torch.tensor([True, False, True, False])
    dm = completion_times(arr, b, f, mask)
    assert torch.isfinite(dm[[0, 2]]).all() and torch.isinf(dm[[1, 3]]).all()


@given(ages=st.lists(st.floats(min_value=0.0, max_value=100.0),
                     min_size=2, max_size=32),
       alpha=st.floats(min_value=0.0, max_value=4.0))
@settings(max_examples=50, deadline=None)
def test_staleness_weight_properties(ages, alpha):
    """w = (1 + age)^(-alpha): positive, at most 1, normalisable,
    non-increasing in age, exactly ones at alpha = 0."""
    agg = AGGREGATORS.resolve({"name": "fedbuff",
                               "params": {"m": 2, "alpha": alpha}})
    w = agg.staleness_weights(torch.tensor(ages, dtype=torch.float64))
    w = w.numpy()
    assert (w > 0).all() and (w <= 1.0 + 1e-12).all()
    assert abs((w / w.sum()).sum() - 1.0) < 1e-9
    order = np.argsort(ages)
    assert (np.diff(w[order]) <= 1e-12).all()
    if alpha == 0.0:
        assert np.array_equal(w, np.ones_like(w))


@given(alpha=st.floats(min_value=1e-3, max_value=4.0))
@settings(max_examples=25, deadline=None)
def test_staleness_weights_discount_strictly(alpha):
    agg = AGGREGATORS.resolve({"name": "fedbuff",
                               "params": {"m": 2, "alpha": alpha}})
    w = agg.staleness_weights(torch.tensor([0.0, 1.0, 4.0])).numpy()
    assert w[0] == 1.0 and w[0] > w[1] > w[2]


# ---------------------------------------------------------------------------
# (b) the port's dense asynchronous run against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[{}, CHURN, FAULTS],
                ids=["no-churn", "churn", "faults"])
def ref_and_port(request):
    spec = dict(TINY, aggregator="fedbuff:2:0.5", **request.param)
    ref = ref_build_experiment(RefSpec(**spec))
    h_ref = ref.run()
    port = build_experiment(ExperimentSpec(**spec), device="cpu",
                            draws=FaultReplayDraws(0))
    h_port = port.run()
    assert h_port.seconds == []               # the device-resident path
    return ref, h_ref, port, h_port


def test_async_run_matches_reference_dispatches_and_traces(ref_and_port):
    _, h_ref, _, h_port = ref_and_port
    assert len(h_port.selected) == len(h_ref.selected) == TINY["rounds"] + 1
    for a, b in zip(h_port.selected, h_ref.selected):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert h_port.participation == h_ref.participation
    assert h_port.active == h_ref.active
    np.testing.assert_allclose(h_port.staleness, h_ref.staleness, rtol=1e-6)
    assert max(h_port.staleness) > 0          # stragglers aged


def test_async_run_matches_reference_T_E_accuracy(ref_and_port):
    _, h_ref, _, h_port = ref_and_port
    np.testing.assert_allclose(h_port.T_k, h_ref.T_k, rtol=2e-3)
    np.testing.assert_allclose(h_port.E_k, h_ref.E_k, rtol=2e-3)
    for a, b in zip(h_port.accuracy, h_ref.accuracy):
        assert abs(a - b) <= 1.0 / TINY["test_samples"] + 1e-6


def test_async_run_matches_reference_state(ref_and_port):
    """The global row, and the scheduler's columns folded back into the
    stats table."""
    ref, _, port, _ = ref_and_port
    np.testing.assert_allclose(
        port.global_vec.numpy(),
        np.asarray(tree_flatten_vector(ref.global_params)), atol=1e-4)
    for col in ("avail", "age", "faults", "strikes"):
        np.testing.assert_array_equal(getattr(port.stats, col),
                                      np.asarray(getattr(ref.stats, col)),
                                      err_msg=col)
    if port.faults is not None:      # the fault arms and quarantine ran
        assert port.stats.faults.sum() > 0
        assert port.stats.strikes.max() >= FAULTS["quarantine_after"]
    for col in ("t_done", "t_now"):
        np.testing.assert_allclose(getattr(port.stats, col),
                                   np.asarray(getattr(ref.stats, col)),
                                   rtol=2e-3)
    for col in ("divergence", "drift"):
        np.testing.assert_allclose(getattr(port.stats, col),
                                   np.asarray(getattr(ref.stats, col)),
                                   rtol=2e-3, atol=1e-4, err_msg=col)


def test_async_guard_matches_reference():
    """A byzantine row past fp32's range (``byz_scale:1e39``) is
    non-finite: it persists to the plane, where its divergence is NaN and
    ranks last in selection (as ``lax.top_k`` ranks x86's NaN), then
    fires, and the receive-side guard weights it out and strikes its
    sender, who leaves flight without a refresh: its drift grows on while
    a finite fired row's resets. Two ticks against the reference: the
    dispatches, the counts, the drift and divergence columns and the
    row."""
    spec = dict(TINY, rounds=2, aggregator="fedbuff:2:0.5", churn_leave=0.05,
                churn_join=0.1,
                faults="outage:0.1,corrupt:0.1,byzantine:0.6,byz_scale:1e39")
    ref = ref_build_experiment(RefSpec(**spec))
    h_ref = ref.run()
    port = build_experiment(ExperimentSpec(**spec), device="cpu",
                            draws=FaultReplayDraws(0))
    h_port = port.run()
    for a, b in zip(h_port.selected, h_ref.selected):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert h_port.participation == h_ref.participation
    for col in ("faults", "strikes", "age", "avail"):
        np.testing.assert_array_equal(getattr(port.stats, col),
                                      np.asarray(getattr(ref.stats, col)),
                                      err_msg=col)
    for col in ("divergence", "drift"):
        np.testing.assert_allclose(getattr(port.stats, col),
                                   np.asarray(getattr(ref.stats, col)),
                                   rtol=2e-3, atol=1e-4, err_msg=col)
    np.testing.assert_allclose(
        port.global_vec.numpy(),
        np.asarray(tree_flatten_vector(ref.global_params)), atol=1e-4)
    # the guard struck more than the corrupt dispatches did, and a struck
    # client kept its drift
    assert port.stats.strikes.sum() > port.stats.faults.sum()
    assert (port.stats.drift[port.stats.strikes > 0] > 0).any()
    assert not np.isfinite(port.client_plane.numpy()).all()


# ---------------------------------------------------------------------------
# (c) port against port
# ---------------------------------------------------------------------------


def test_full_buffer_is_the_sync_run_bit_for_bit():
    """``fedbuff:8:0`` (M >= S_pad = 4, no churn) takes the tick's static
    branch, the synchronous round body itself: every history value and
    the global row bit for bit, with participation S and staleness 0."""
    sync = build_experiment(ExperimentSpec(**TINY), device="cpu")
    h_s = sync.run()
    buf = build_experiment(ExperimentSpec(**TINY, aggregator="fedbuff:8:0"),
                           device="cpu")
    h_b = buf.run()
    assert h_b.seconds == []
    for name in ("accuracy", "T_k", "E_k", "band_mhz"):
        assert getattr(h_s, name) == getattr(h_b, name), name
    for a, b in zip(h_s.selected, h_b.selected):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(sync.global_vec, buf.global_vec)
    assert torch.equal(sync.client_plane, buf.client_plane)
    assert h_b.participation == [4.0] * TINY["rounds"]
    assert h_b.staleness == [0.0] * TINY["rounds"]
    assert h_b.active == [8.0] * TINY["rounds"]


def test_empty_fire_is_a_noop():
    """Everyone leaves at the first tick: nothing is dispatched, the buffer
    never fires, and the global row passes through untouched — constant
    accuracy, zero participation, finite T and E."""
    exp = build_experiment(ExperimentSpec(**TINY, aggregator="fedbuff:2",
                                          churn_leave=1.0, churn_join=0.0),
                           device="cpu")
    exp.run(rounds=1)
    before = exp.global_vec.clone()
    h = exp.run(rounds=3, include_initial_round=False)
    assert h.active == [0.0] * 3 and h.participation == [0.0] * 3
    assert h.staleness == [0.0] * 3
    assert all(len(s) == 0 for s in h.selected)
    assert np.all(np.isfinite(h.T_k)) and np.all(np.isfinite(h.E_k))
    assert len(set(h.accuracy)) == 1
    assert torch.equal(exp.global_vec, before)
    assert np.isinf(exp.stats.t_done).all()


@pytest.mark.parametrize("selection", ["stochastic-sched", "divergence",
                                       "icas"])
def test_churn_never_dispatches_an_unavailable_client(selection):
    """Churn precedes selection inside the tick and nothing changes the
    mask after it, so after a one-tick run ``stats.avail`` is the mask the
    selector saw: every dispatch lies in it, and no unavailable client is
    in flight. A stochastic selector takes its draws from the experiment's
    draws object (the asynchronous engine has no host loop)."""
    exp = build_experiment(ExperimentSpec(
        **TINY, aggregator="fedbuff:2", selection=selection,
        churn_leave=0.4, churn_join=0.4), device="cpu")
    exp.run(rounds=1)
    for _ in range(4):
        h = exp.run(rounds=1, include_initial_round=False)
        avail = set(np.flatnonzero(exp.stats.avail).tolist())
        assert {int(i) for i in h.selected[-1]} <= avail
        assert np.isinf(exp.stats.t_done[~exp.stats.avail]).all()


def test_async_state_persists_across_runs():
    """The scheduler's columns ride the store's stats table across the
    host boundary: a second ``run()`` continues the virtual clock, and
    one-tick runs give the ticks of one run bit for bit."""
    spec = ExperimentSpec(**TINY, aggregator="fedbuff:2:0.5", **CHURN)
    exp = build_experiment(spec, device="cpu")
    assert isinstance(exp.stats, ClientStats) and exp.stats is exp.store.stats
    assert float(exp.stats.t_now) == 0.0
    h1 = exp.run(rounds=1)
    t1 = float(exp.stats.t_now)
    assert t1 > 0.0
    h2 = exp.run(rounds=2, include_initial_round=False)
    assert float(exp.stats.t_now) >= t1
    whole = build_experiment(spec, device="cpu")
    h = whole.run()
    assert h.accuracy == h1.accuracy + h2.accuracy
    assert h.participation == h1.participation + h2.participation
    assert h.T_k == h1.T_k + h2.T_k
    assert torch.equal(whole.global_vec, exp.global_vec)
    for col in ("avail", "t_done", "age", "t_now", "divergence", "drift"):
        assert np.array_equal(getattr(whole.stats, col),
                              getattr(exp.stats, col)), col


def test_tick_keeps_the_stats_table_consistent():
    """After every tick: the fired clients left flight, the in-flight ones
    all have a finite completion time after the clock, and at most M
    updates folded."""
    exp = build_experiment(ExperimentSpec(**TINY, aggregator="fedbuff:1:0.5",
                                          selection="icas"), device="cpu")
    exp.run(rounds=1)
    for _ in range(3):
        h = exp.run(rounds=1, include_initial_round=False)
        st = exp.stats
        assert h.participation[-1] <= 1
        live = np.isfinite(st.t_done)
        assert (st.t_done[live] >= st.t_now).all()
        assert (st.age[~live] == 0).all()
        assert (st.divergence >= 0).all() and (st.drift >= 0).all()


# ---------------------------------------------------------------------------
# (d) the cohort
# ---------------------------------------------------------------------------


def test_async_cohort_traces_and_lanes_equal_single_runs():
    """M = 1 on a pad-4 selection leaves stragglers in flight: the
    cohort's ``[2, R]`` traces show staleness > 0, one update a fire and
    the whole fleet active; each lane is its seed's single run bit for
    bit; a synchronous cohort has no traces."""
    spec = ExperimentSpec(**TINY, aggregator="fedbuff:1:0.5", cohort=2)
    runner = build_cohort(spec, device="cpu")
    ch = runner.run()
    R = TINY["rounds"]
    assert ch.participation.shape == ch.staleness.shape == (2, R)
    assert (ch.participation == 1).all() and ch.staleness.max() > 0
    assert (ch.active == TINY["clients"]).all()
    for i, seed in enumerate(ch.seeds):
        single = build_experiment(spec.replace(seed=seed, cohort=1),
                                  device="cpu")
        h = single.run()
        hi = ch.history(i)
        for a, b in zip(hi.selected, h.selected):
            np.testing.assert_array_equal(a, b)
        for name in ("accuracy", "T_k", "E_k", "participation",
                     "staleness", "active"):
            assert getattr(hi, name) == getattr(h, name), name
        assert torch.equal(runner.experiments[i].global_vec,
                           single.global_vec)
        for col in ("t_done", "age", "avail", "t_now"):
            assert np.array_equal(getattr(runner.experiments[i].stats, col),
                                  getattr(single.stats, col)), col
    sync = build_cohort(ExperimentSpec(**TINY, cohort=2), device="cpu").run()
    assert sync.participation is None and sync.staleness is None


def test_async_cohort_under_churn():
    ch = build_cohort(ExperimentSpec(**TINY, aggregator="fedbuff:2",
                                     cohort=2, **CHURN), device="cpu").run()
    assert ch.active.shape == (2, TINY["rounds"])
    assert ch.active.min() < TINY["clients"]
    assert np.isfinite(ch.accuracy).all() and np.isfinite(ch.T_k).all()


# ---------------------------------------------------------------------------
# (e) the refusals
# ---------------------------------------------------------------------------


def test_refusals():
    exp = build_experiment(ExperimentSpec(**TINY, aggregator="fedbuff:2"),
                           device="cpu")
    with pytest.raises(ValueError, match="target_accuracy"):
        exp.run(target_accuracy=0.5)
    kw = dict(selector=exp.selector, allocator=exp.allocator,
              tctx=exp.traced_context(), feature_layer="auto",
              device="cpu", shapes=())
    with pytest.raises(ValueError, match="async"):
        engine.run_rounds(exp.engine_cfg, aggregator=AGGREGATORS.resolve(
            "fedavg"), churn=(0.1, 0.0), **kw)
    with pytest.raises(ValueError, match="single-cell"):
        engine.run_rounds(exp.engine_cfg, aggregator=exp.aggregator,
                          cells=2, **kw)
    with pytest.raises(ValueError, match="paged"):
        build_cohort(ExperimentSpec(**TINY, aggregator="fedbuff:2",
                                    store="paged"), device="cpu")
    with pytest.raises(ValueError, match="churn.*store='paged'"):
        build_experiment(ExperimentSpec(**TINY, churn_leave=0.1),
                         device="cpu")
