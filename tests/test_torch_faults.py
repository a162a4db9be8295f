"""The port's fault-tolerant runtime against the reference
(``tests/test_faults.py``'s cases, on the CPU).

``FaultSpec``, its parsing and its refusals match the reference's word
for word; the robust folds (``trimmed:f``, ``clipnorm:c``) match the
reference's ``aggregate_flat`` on the same numpy-seeded rows (atol 1e-6);
a faulty host-loop run fed the reference's key stream (its fault masks and
byzantine subset included) makes the reference's selections and fault
counts, its row within atol 1e-4 and T/E within rtol 2e-3. The route pins
are port against port, bit for bit: the device-resident run ≡ the host
loop under faults and quarantine, the dense ≡ the paged asynchronous tick
under faults and churn.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as RefSpec
from repro.api import build_cohort as ref_build_cohort
from repro.api import build_experiment as ref_build_experiment
from repro.api.registry import AGGREGATORS as REF_AGGREGATORS
from repro.core.faults import FaultSpec as RefFaultSpec
from repro.core.faults import draw_fault_masks as ref_draw_fault_masks
from repro.utils.trees import tree_flatten_vector

from repro_torch.api import ExperimentSpec, build_cohort, build_experiment
from repro_torch.api.registry import AGGREGATORS, StrategyError
from repro_torch.api.scenario import FleetSpec
from repro_torch.core.clustering import clusters_from_labels
from repro_torch.core.draws import TorchDraws
from repro_torch.core.faults import (FAULT_KINDS, FaultSpec,
                                     byzantine_clients, chan_outage_threshold,
                                     draw_fault_masks)
from repro_torch.utils.trees import flatten_vector, unflatten_vector

from test_torch_slice import FaultReplayDraws

TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=3, devices_per_round=4, num_clusters=4,
            learning_rate=0.05, selection="divergence")
PAGED = dict(store="paged", k_max=8, div_refresh_every=1)
SCHED_COLUMNS = ("age", "t_done", "avail", "t_now", "cell", "faults",
                 "strikes")


def _error(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


# ---------------------------------------------------------------------------
# FaultSpec
# ---------------------------------------------------------------------------


def test_fault_spec_parse_roundtrip_matches_the_reference():
    s = "outage:0.1,corrupt:0.05,byzantine:0.2,byz_scale:3,deadline:0.4"
    fs, ref = FaultSpec.from_string(s), RefFaultSpec.from_string(s)
    assert fs.to_dict() == ref.to_dict()
    assert fs.active and not FaultSpec().active
    assert FaultSpec.normalize(fs.to_dict()) == fs
    assert FaultSpec.normalize(None) is None
    assert FaultSpec.normalize(fs) is fs
    assert set(FAULT_KINDS) == set(RefFaultSpec.__dataclass_fields__)
    assert hash(fs) == hash(FaultSpec.from_string(s))


@pytest.mark.parametrize("bad", ["nonsense:0.5", "outage:1.5", "outage:-0.1",
                                 "byz_scale:-1", "deadline:-2", "outage",
                                 "corrupt:x", "byz_scale:inf"])
def test_fault_spec_rejects_as_the_reference(bad):
    got = _error(FaultSpec.from_string, bad)
    assert got[0] is ValueError
    assert got == _error(RefFaultSpec.from_string, bad)


@pytest.mark.parametrize("bad", [{"nope": 1}, 3.0])
def test_fault_spec_normalize_rejects_as_the_reference(bad):
    assert _error(FaultSpec.normalize, bad) == _error(RefFaultSpec.normalize,
                                                      bad)


def test_chan_outage_threshold_matches_the_reference():
    from repro.core.faults import chan_outage_threshold as ref_threshold
    for rate in (0.0, 0.1, 0.5, 1.0):
        assert chan_outage_threshold(rate) == ref_threshold(rate)


def test_fault_masks_shapes_and_rates():
    draws = TorchDraws(0, "cpu")
    m = draw_fault_masks(FaultSpec.from_string("outage:1.0,corrupt:0.0"),
                         (32,), draws)
    assert m.shape == (2, 32) and m.dtype == torch.bool
    assert bool(m[0].all()) and not bool(m[1].any())
    m = draw_fault_masks(FaultSpec(outage=0.3, corrupt=0.1), (20000,), draws)
    assert abs(float(m[0].float().mean()) - 0.3) < 0.02
    assert abs(float(m[1].float().mean()) - 0.1) < 0.02
    # an active spec takes the same draws whatever its rates
    a, b = TorchDraws(5, "cpu"), TorchDraws(5, "cpu")
    draw_fault_masks(FaultSpec(outage=0.9), (7,), a)
    draw_fault_masks(FaultSpec(corrupt=0.2), (7,), b)
    assert torch.equal(a.batch_indices(2, 1, 3, 10),
                       b.batch_indices(2, 1, 3, 10))


def test_byzantine_subset_is_its_own_stream():
    spec = FaultSpec(byzantine=0.25, seed=3)
    draws = TorchDraws(0, "cpu")
    before = draws.generator.get_state()
    m = byzantine_clients(spec, 4000, draws)
    assert torch.equal(draws.generator.get_state(), before)
    assert m.dtype == bool and abs(m.mean() - 0.25) < 0.03
    assert np.array_equal(m, byzantine_clients(spec, 4000,
                                               TorchDraws(9, "cpu")))
    assert not byzantine_clients(FaultSpec(), 10, draws).any()


def test_replayed_masks_are_the_reference_bernoullis():
    """The parity tests' replay hands the port the reference's masks."""
    spec = FaultSpec(outage=0.4, corrupt=0.3)
    m = FaultReplayDraws(0).fault_masks(spec, (6,))
    ref = FaultReplayDraws(0)
    drop, corrupt = ref_draw_fault_masks(ref._next(),
                                         RefFaultSpec(**spec.to_dict()), (6,))
    assert np.array_equal(m.numpy(), np.stack([drop, corrupt]))


def test_chan_outage_needs_stateful_channel():
    spec = ExperimentSpec(**TINY, faults="chan_outage:0.2")
    got = _error(build_experiment, spec, device="cpu")
    assert got == _error(ref_build_experiment,
                         RefSpec(**TINY, faults="chan_outage:0.2"))
    assert "stateful" in got[1]
    ok = ExperimentSpec(**TINY, faults="chan_outage:0.2",
                        fleet=FleetSpec(channel="gauss-markov"))
    exp = build_experiment(ok, device="cpu")
    exp.run(rounds=2)
    assert np.all(exp.stats.faults >= 0) and exp.stats.faults.sum() > 0


def test_build_cohort_refuses_faults_with_the_reference_words():
    for kw in (dict(faults="outage:0.1"), dict(quarantine_after=2)):
        got = _error(build_cohort, ExperimentSpec(**TINY, cohort=2, **kw),
                     device="cpu")
        assert got == _error(ref_build_cohort,
                             RefSpec(**TINY, cohort=2, **kw))
        assert "cohort" in got[1]


def test_multicell_refusal():
    from repro_torch.api.scenario import multicell_fleet_spec
    spec = ExperimentSpec(**TINY, faults="outage:0.1",
                          fleet=multicell_fleet_spec(2))
    exp = build_experiment(spec, device="cpu")
    from repro_torch.core.engine import run_rounds
    with pytest.raises(ValueError, match="single-cell programs only"):
        run_rounds(exp.engine_cfg, selector=exp.selector,
                   allocator=exp.allocator, aggregator=exp.aggregator,
                   tctx=exp.traced_context(), feature_layer="auto",
                   device="cpu", shapes=(), cells=2, faults=exp.faults)


# ---------------------------------------------------------------------------
# the robust aggregators
# ---------------------------------------------------------------------------


def test_robust_aggregator_parsing_and_validation():
    tm = AGGREGATORS.resolve("trimmed:0.2")
    assert tm.f == 0.2 and tm.traceable and not tm.fuses_with_engine
    cn = AGGREGATORS.resolve("clipnorm:1.5")
    assert cn.c == 1.5 and cn.traceable and not cn.fuses_with_engine
    assert tm.params() == REF_AGGREGATORS.resolve("trimmed:0.2").params()
    for bad in ("trimmed:0.5", "clipnorm:0"):
        with pytest.raises(StrategyError) as got:
            AGGREGATORS.resolve(bad)
        with pytest.raises(Exception) as want:
            REF_AGGREGATORS.resolve(bad)
        assert str(got.value) == str(want.value)


def _rows(seed, s=7, p=33, dead=(2, 5)):
    rng = np.random.default_rng(seed)
    g = rng.normal(scale=0.1, size=p).astype(np.float32)
    rows = (g + rng.normal(scale=0.1, size=(s, p))).astype(np.float32)
    rows[3] *= 40.0                                    # one outlier lane
    w = rng.uniform(1, 3, size=s).astype(np.float32)
    for j in dead:                  # lost / guarded / padding lanes
        rows[j] = np.nan
        w[j] = 0.0
    return g, rows, w


def _both(name, g, rows, w):
    port, _ = AGGREGATORS.resolve(name).aggregate_flat(
        torch.tensor(g), torch.tensor(rows), torch.tensor(w), None)
    ref, _ = REF_AGGREGATORS.resolve(name).aggregate_flat(
        jnp.asarray(g), jnp.asarray(rows), jnp.asarray(w), None)
    return port.numpy(), np.asarray(ref)


@pytest.mark.parametrize("f", [0.0, 0.2, 0.4])
@pytest.mark.parametrize("seed", [0, 1])
def test_trimmed_mean_matches_the_reference(f, seed):
    port, ref = _both(f"trimmed:{f}", *_rows(seed))
    assert np.all(np.isfinite(port))
    np.testing.assert_allclose(port, ref, atol=1e-6, rtol=0)


def test_trimmed_mean_drops_outlier_lanes():
    g = np.zeros(3, np.float32)
    rows = np.asarray([[1, 1, 1], [2, 2, 2], [3, 3, 3], [1e6, -1e6, 1e6],
                       [np.nan] * 3], np.float32)
    w = np.asarray([1, 1, 1, 1, 0], np.float32)
    port, ref = _both("trimmed:0.25", g, rows, w)
    assert np.array_equal(port, ref)
    assert np.allclose(port, [2.5, 1.5, 2.5])


def test_clipnorm_degenerates_to_fedavg():
    from repro_torch.kernels import ops
    port, ref = _both("clipnorm:1e9", *_rows(3))
    np.testing.assert_allclose(port, ref, atol=1e-6, rtol=0)
    # the reference's own case: g + (w − g) is w exactly at these values
    g = np.asarray([1.0, -1.0, 0.5], np.float32)
    rows = np.asarray([[2.0, 0.0, 1.0], [0.0, -2.0, 0.0]], np.float32)
    w = np.asarray([1.0, 3.0], np.float32)
    port, ref = _both("clipnorm:1e9", g, rows, w)
    assert np.array_equal(port, ref)
    assert np.array_equal(port, ops.flat_aggregate(torch.tensor(rows),
                                                   torch.tensor(w)).numpy())


@pytest.mark.parametrize("c", [0.5, 1.0, 4.0])
def test_clipnorm_matches_the_reference_and_bounds_a_pull(c):
    port, ref = _both(f"clipnorm:{c}", *_rows(4))
    np.testing.assert_allclose(port, ref, atol=1e-6, rtol=0)
    one, _ = AGGREGATORS.resolve(f"clipnorm:{c}").aggregate_flat(
        torch.zeros(4), torch.tensor([[1e4, 0.0, 0.0, 0.0]]), torch.ones(1))
    assert float(torch.linalg.vector_norm(one)) <= c * (1 + 1e-6)


def test_robust_host_contract_over_stacked_models():
    """``aggregate`` over ``{name: [S, ...]}`` is the flat fold."""
    tm = AGGREGATORS.resolve("trimmed:0.2")
    rng = np.random.default_rng(0)
    g = {"a": torch.tensor(rng.normal(size=(2, 3)), dtype=torch.float32),
         "b": torch.tensor(rng.normal(size=4), dtype=torch.float32)}
    st = {k: v + torch.tensor(rng.normal(size=(5,) + tuple(v.shape)),
                              dtype=torch.float32) for k, v in g.items()}
    out = tm.aggregate(g, st, torch.ones(5))
    ref = REF_AGGREGATORS.resolve("trimmed:0.2").aggregate(
        {k: jnp.asarray(v.numpy()) for k, v in g.items()},
        {k: jnp.asarray(v.numpy()) for k, v in st.items()}, jnp.ones(5))
    for k in g:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# a faulty host loop against the reference, on the reference's draws
# ---------------------------------------------------------------------------


def _host_pair(kw, rounds):
    ref = ref_build_experiment(RefSpec(**kw))
    port = build_experiment(ExperimentSpec(**kw), device="cpu",
                            draws=FaultReplayDraws(0))
    out = {}
    for exp, side in ((ref, "ref"), (port, "port")):
        exp.initial_round()
        out[side] = [exp.round() for _ in range(rounds)]
    return ref, port, out


@pytest.mark.parametrize("kw,rounds", [
    (dict(faults="outage:0.3,corrupt:0.3,byzantine:0.25"), 3),
    (dict(faults="outage:0.2,corrupt:0.2,byzantine:0.25",
          aggregator="trimmed:0.2"), 3),
    (dict(faults="outage:0.2,corrupt:0.3,byzantine:0.25",
          aggregator="clipnorm:1.0", quarantine_after=1), 1),
    (dict(faults="deadline:0.5,corrupt:0.2"), 2),
], ids=["fedavg", "trimmed", "clipnorm-quarantine", "deadline"])
def test_faulty_host_rounds_match_the_reference(kw, rounds):
    ref, port, out = _host_pair(dict(TINY, **kw), rounds)
    for r, p in zip(out["ref"], out["port"]):
        np.testing.assert_array_equal(p.selected, r.selected)
        np.testing.assert_allclose(p.T_k, float(r.T_k), rtol=2e-3)
        np.testing.assert_allclose(p.E_k, float(r.E_k), rtol=2e-3)
    np.testing.assert_array_equal(port.stats.faults, ref.stats.faults)
    np.testing.assert_array_equal(port.stats.strikes, ref.stats.strikes)
    assert port.stats.faults.sum() > 0
    np.testing.assert_allclose(port.global_vec.numpy(),
                               np.asarray(tree_flatten_vector(
                                   ref.global_params)), atol=1e-4)


def test_byzantine_held_to_the_reference_outputs():
    """The reference's own bound test fails (``test_byzantine_bounded_by_
    trimmed_mean``), so the port is held to the reference's rows under a
    negate-and-amplify cohort, plain and trimmed, on the reference's
    draws (relative to the rows' scale). The port takes a fault draw only
    under a stochastic rate, where the reference splits its key for any
    active spec, so the spec carries an outage rate too small to fire
    and both streams stay in step."""
    faults = "byzantine:0.25,byz_scale:50,outage:1e-9"
    for agg in ("fedavg", "trimmed:0.3"):
        ref, port, _ = _host_pair(dict(TINY, faults=faults, aggregator=agg),
                                  2)
        want = np.asarray(tree_flatten_vector(ref.global_params))
        got = port.global_vec.numpy()
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("agg", ["fedavg", "trimmed:0.2"])
def test_traced_quarantine_matches_the_reference_traced_run(agg):
    """The device-resident run against the reference's traced ``run()``
    over 4 rounds on the reference's fault masks, with ``quarantine_after
    =1`` so that quarantine takes effect inside the compared rounds: the
    port runs one round a call (its draws and counts carry over), and no
    round selects a client struck before it; selections, T/E, the fault
    and strike counts and the row match the reference's."""
    kw = dict(TINY, rounds=4, aggregator=agg, quarantine_after=1,
              faults="outage:0.2,corrupt:0.3,byzantine:0.25")
    ref = ref_build_experiment(RefSpec(**kw))
    assert ref.traceable()
    h_ref = ref.run()
    port = build_experiment(ExperimentSpec(**kw), device="cpu",
                            draws=FaultReplayDraws(0))
    hist = port.run(rounds=1)
    masked = 0
    for _ in range(kw["rounds"] - 1):
        struck = np.flatnonzero(port.stats.strikes >= 1)
        h = port.run(rounds=1, include_initial_round=False)
        assert not h.seconds                      # the device-resident run
        assert not np.intersect1d(h.selected[0], struck).size
        masked += kw["devices_per_round"] - len(h.selected[0])
        hist.extend(h)
    assert masked > 0                             # a quarantined lane
    assert len(hist.selected) == len(h_ref.selected) == kw["rounds"] + 1
    for a, b in zip(hist.selected, h_ref.selected):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(hist.T_k, h_ref.T_k, rtol=2e-3)
    np.testing.assert_allclose(hist.E_k, h_ref.E_k, rtol=2e-3)
    for a, b in zip(hist.accuracy, h_ref.accuracy):
        assert abs(a - b) <= 1.0 / TINY["test_samples"] + 1e-6
    for col in ("faults", "strikes"):
        np.testing.assert_array_equal(getattr(port.stats, col),
                                      np.asarray(getattr(ref.stats, col)),
                                      err_msg=col)
    np.testing.assert_allclose(port.global_vec.numpy(),
                               np.asarray(tree_flatten_vector(
                                   ref.global_params)), atol=1e-4)


# ---------------------------------------------------------------------------
# the route pins, port against port
# ---------------------------------------------------------------------------


def _gvec(exp):
    return exp.global_vec.numpy()


@pytest.mark.parametrize("agg", ["trimmed:0.2", "clipnorm:1.0", "fedavgm:0.9"])
def test_traced_host_parity_under_faults(agg):
    """The device-resident run and the host loop draw the same faults over
    the same lanes (a quarantined client keeps its lane, masked): history,
    row and the counts agree bit for bit."""
    kw = dict(TINY, faults="outage:0.3,corrupt:0.2,byzantine:0.2",
              quarantine_after=1, aggregator=agg)
    e_t = build_experiment(ExperimentSpec(**kw), device="cpu")
    e_h = build_experiment(ExperimentSpec(**kw), device="cpu")
    h_t = e_t.run(rounds=5)
    h_h = e_h.run(rounds=5, target_accuracy=2.0)
    assert not h_t.seconds and h_h.seconds         # the two paths ran
    assert h_t.accuracy == h_h.accuracy and h_t.T_k == h_h.T_k
    for a, b in zip(h_t.selected, h_h.selected):
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(_gvec(e_t), _gvec(e_h))
    for col in ("faults", "strikes"):
        assert np.array_equal(getattr(e_t.stats, col),
                              getattr(e_h.stats, col)), col
    assert e_t.stats.strikes.max() >= 1            # quarantine was met


def test_inactive_faults_leave_the_run_as_it_was():
    plain = build_experiment(ExperimentSpec(**TINY), device="cpu")
    off = build_experiment(ExperimentSpec(**TINY, faults=FaultSpec()),
                           device="cpu")
    assert plain.run().accuracy == off.run().accuracy
    assert np.array_equal(_gvec(plain), _gvec(off))
    assert plain.traced_state().sched is None


def _preset(exp):
    """A partition with every cluster populated, so no initial round runs
    (it trains all clients fault-free by design)."""
    labels = np.arange(exp.fed.num_clients) % exp.fl.num_clusters
    exp.cluster_labels = labels
    exp.clusters = clusters_from_labels(labels, exp.fl.num_clusters)


@pytest.mark.parametrize("target", [2.0, 0.0], ids=["host", "traced"])
def test_all_failed_round_is_a_noop(target):
    """outage:1.0 — every upload lost: the global row and FedAvgM's
    momentum pass through, finite, on both paths."""
    exp = build_experiment(ExperimentSpec(**TINY, faults="outage:1.0",
                                          aggregator="fedavgm:0.9"),
                           device="cpu")
    _preset(exp)
    ones = torch.ones(exp.flat_spec.total)
    exp.aggregator._opt.v = unflatten_vector(exp.flat_spec, ones)
    g0, plane0 = _gvec(exp).copy(), exp.client_plane.clone()
    hist = exp.run(rounds=2, include_initial_round=False,
                   target_accuracy=target)
    assert bool(hist.seconds) == bool(target)
    assert np.array_equal(_gvec(exp), g0)
    assert torch.equal(exp.client_plane, plane0)
    assert torch.equal(flatten_vector(exp.flat_spec, exp.aggregator._opt.v),
                       ones)
    assert np.all(np.isfinite(hist.accuracy))
    assert exp.stats.faults.sum() == 2 * TINY["devices_per_round"]


def test_quarantine_excludes_repeat_offenders():
    exp = build_experiment(ExperimentSpec(**TINY, faults="corrupt:0.6",
                                          quarantine_after=2), device="cpu")
    exp.run(rounds=6, target_accuracy=2.0)
    quarantined = np.flatnonzero(exp.stats.strikes >= 2)
    assert quarantined.size
    hist = exp.run(rounds=3, include_initial_round=False,
                   target_accuracy=2.0)
    for sel in hist.selected:
        assert not np.intersect1d(sel, quarantined).size


def test_async_dense_paged_parity_under_faults_and_churn():
    kw = dict(TINY, aggregator="fedbuff:2:0.5",
              faults="outage:0.2,corrupt:0.3,byzantine:0.2",
              quarantine_after=2, churn_leave=0.05, churn_join=0.1)
    e_d = build_experiment(ExperimentSpec(**kw), device="cpu")
    e_p = build_experiment(ExperimentSpec(**kw, **PAGED), device="cpu")
    h_d = e_d.run(rounds=6)
    h_p = e_p.run(rounds=6)
    assert h_d.accuracy == h_p.accuracy and h_d.T_k == h_p.T_k
    assert h_d.participation == h_p.participation
    for a, b in zip(h_d.selected, h_p.selected):
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(_gvec(e_d), _gvec(e_p))
    for col in SCHED_COLUMNS:
        assert np.array_equal(getattr(e_d.stats, col),
                              getattr(e_p.stats, col)), col
    assert e_d.stats.faults.sum() > 0 and e_d.stats.strikes.sum() > 0


def test_paged_round_persists_only_what_landed():
    """A lost upload never reaches the paged store: with every upload lost
    (and no initial round: ``random`` needs no clusters) no row is
    touched, the table's upkeep does not run and the row stays."""
    exp = build_experiment(ExperimentSpec(**dict(TINY, selection="random"),
                                          **PAGED, faults="outage:1.0"),
                           device="cpu")
    g0 = _gvec(exp).copy()
    hist = exp.run(rounds=2, include_initial_round=False)
    assert len(hist.selected) == 2
    assert not exp.store.touched.any() and not exp.stats.age.any()
    assert np.array_equal(_gvec(exp), g0)
    assert exp.stats.faults.sum() == 2 * TINY["devices_per_round"]


def test_deadline_on_both_sides_of_the_rounds_T():
    """SAO equalises completion times, so a deadline drops a round's every
    dispatch or none: above the rounds' T the run is the deadline-free run
    bit for bit (a deadline takes no draw); far below it every round is
    the all-failed no-op, the row and FedAvgM's momentum passing
    through."""
    kw = dict(TINY, aggregator="fedavgm:0.9")
    base = build_experiment(ExperimentSpec(**kw), device="cpu")
    h0 = base.run(rounds=3)
    above = build_experiment(ExperimentSpec(
        **kw, faults=f"deadline:{2 * max(h0.T_k)}"), device="cpu")
    h1 = above.run(rounds=3)
    assert h1.accuracy == h0.accuracy and h1.T_k == h0.T_k
    assert np.array_equal(_gvec(above), _gvec(base))
    assert above.stats.faults.sum() == 0
    below = build_experiment(ExperimentSpec(
        **kw, faults=f"deadline:{1e-3 * min(h0.T_k)}"), device="cpu")
    below.initial_round()
    g0 = _gvec(below).copy()
    v0 = flatten_vector(below.flat_spec, below.aggregator._opt.v)
    below.run(rounds=3, include_initial_round=False)
    assert np.array_equal(_gvec(below), g0)
    assert torch.equal(flatten_vector(below.flat_spec,
                                      below.aggregator._opt.v), v0)
    assert below.stats.faults.sum() == 3 * TINY["devices_per_round"]
