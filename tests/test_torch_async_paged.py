"""The buffered-asynchronous engine on the paged store
(``FLExperiment._run_async_paged``: the tick as four eager pieces with the
store's staging in between, ``async_engine.build_paged_async``), on the
CPU, at the reference's sizes (``tests/test_async_paged.py``: 8 clients,
a pad-4 ``icas`` selection, ``fedbuff:2:0.5`` so stragglers stay in
flight every tick).

(a) dense ≡ paged, port against port, bit for bit with and without churn:
    the history and its traces, the global row and the stats table's
    ``age``, ``t_done``, ``avail`` and ``t_now`` — the paged refresh at
    ``div_refresh_every=1`` reproduces the dense tick's divergence over
    the plane, the candidates' fold sums in the same order;
(b) the paged run against the reference's, replaying its key stream, at
    ``test_torch_slice.py``'s tolerances, under churn and under faults,
    byzantine clients and quarantine with churn (the fault and strike
    counts equal);
(c) churn cancels in-flight work (the scheduler and ``stats.avail`` are
    one table), the clock and the divergence/drift columns persist across
    ``run()`` calls, ``target_accuracy`` stops early, nothing of the
    device carries an ``[N, P]`` plane.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as RefSpec
from repro.api import build_experiment as ref_build_experiment
from repro.core.clustering import clusters_from_labels as ref_clusters
from repro.utils.trees import tree_flatten_vector

from repro_torch.api import ExperimentSpec, build_experiment
from repro_torch.core.clustering import clusters_from_labels

from test_torch_slice import FaultReplayDraws

TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=3, devices_per_round=4, num_clusters=4,
            learning_rate=0.05, selection="icas",
            aggregator="fedbuff:2:0.5")
PAGED = dict(store="paged", k_max=8, div_refresh_every=1)
CHURN = dict(churn_leave=0.3, churn_join=0.3)
FAULTS = dict(faults="outage:0.2,corrupt:0.3,byzantine:0.2",
              quarantine_after=1, churn_leave=0.05, churn_join=0.1)
GUARD = dict(faults="outage:0.1,corrupt:0.1,byzantine:0.6,byz_scale:1e39",
             churn_leave=0.05, churn_join=0.1)


def _preset_clusters(exp, clusters=clusters_from_labels):
    """The no-initial-round entry point for both drivers: the dense run
    would run the initial round without clusters, the paged one (``icas``
    needs none) would not — one trivial partition keeps both off it."""
    exp.cluster_labels = np.zeros(exp.fed.num_clients, np.int64)
    exp.clusters = clusters(exp.cluster_labels, exp.fl.num_clusters)
    return exp


def _run(spec, draws=None):
    exp = _preset_clusters(build_experiment(ExperimentSpec(**spec),
                                            device="cpu", draws=draws))
    return exp, exp.run(rounds=TINY["rounds"], include_initial_round=False)


# ---------------------------------------------------------------------------
# (a) dense ≡ paged
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [{}, CHURN], ids=["no-churn", "churn"])
def test_async_dense_paged_bit_identical(extra):
    e_d, h_d = _run(dict(TINY, **extra))
    e_p, h_p = _run(dict(TINY, **PAGED, **extra))
    assert h_d.seconds == [] and len(h_p.seconds) == TINY["rounds"]
    for name in ("accuracy", "T_k", "E_k", "band_mhz", "participation",
                 "staleness", "active"):
        assert getattr(h_d, name) == getattr(h_p, name), name
    for a, b in zip(h_d.selected, h_p.selected):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(e_d.global_vec, e_p.global_vec)
    for col in ("age", "t_done", "avail", "t_now"):
        assert np.array_equal(getattr(e_d.stats, col),
                              getattr(e_p.stats, col)), col
    # the dispatched rows are the dense plane's
    tree = e_p.client_tree()
    plane = e_d.client_plane.numpy()
    flat = np.concatenate([tree[n].reshape(8, -1) for n in tree], axis=1)
    assert np.array_equal(flat, plane)
    if extra:
        assert min(h_p.active) < TINY["clients"]     # churn did something
    assert max(h_p.staleness) > 0


# ---------------------------------------------------------------------------
# (b) against the reference's paged composition
# ---------------------------------------------------------------------------


def _matches_reference(extra):
    spec = dict(TINY, **PAGED, **extra)
    ref = _preset_clusters(ref_build_experiment(RefSpec(**spec)),
                           clusters=ref_clusters)
    h_ref = ref.run(rounds=TINY["rounds"], include_initial_round=False)
    port, h_port = _run(spec, draws=FaultReplayDraws(0))
    for a, b in zip(h_port.selected, h_ref.selected):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert h_port.participation == h_ref.participation
    assert h_port.active == h_ref.active
    np.testing.assert_allclose(h_port.staleness, h_ref.staleness, rtol=1e-6)
    np.testing.assert_allclose(h_port.T_k, h_ref.T_k, rtol=2e-3)
    np.testing.assert_allclose(h_port.E_k, h_ref.E_k, rtol=2e-3)
    for a, b in zip(h_port.accuracy, h_ref.accuracy):
        assert abs(a - b) <= 1.0 / TINY["test_samples"] + 1e-6
    np.testing.assert_allclose(
        port.global_vec.numpy(),
        np.asarray(tree_flatten_vector(ref.global_params)), atol=1e-4)
    np.testing.assert_array_equal(port.stats.avail, ref.stats.avail)
    return port, ref


def test_async_paged_matches_reference():
    _matches_reference(CHURN)


def test_async_paged_matches_reference_under_faults():
    """The paged ``plan``'s fault draw at dispatch, the byzantine rows in
    ``train``, the guard in ``fire`` and quarantine in ``sched``, against
    the reference's paged pieces: the fault and strike counts equal, a
    client quarantined, and the divergence column within the row's
    tolerance (a guarded candidate refreshes nothing)."""
    port, ref = _matches_reference(FAULTS)
    for col in ("faults", "strikes", "age"):
        np.testing.assert_array_equal(getattr(port.stats, col),
                                      np.asarray(getattr(ref.stats, col)),
                                      err_msg=col)
    for col in ("divergence", "drift", "t_done"):
        np.testing.assert_allclose(getattr(port.stats, col),
                                   np.asarray(getattr(ref.stats, col)),
                                   rtol=2e-3, atol=1e-4, err_msg=col)
    assert port.stats.faults.sum() > 0
    assert port.stats.strikes.max() >= FAULTS["quarantine_after"]


def test_async_paged_guard_matches_reference():
    """Byzantine rows past fp32's range reach the store non-finite; the
    ``fire`` piece's guard weights them out and strikes their senders
    (more strikes than corrupt dispatches), as the reference's does; the
    refreshed divergence column (NaN on a non-finite row) matches."""
    port, ref = _matches_reference(GUARD)
    for col in ("faults", "strikes"):
        np.testing.assert_array_equal(getattr(port.stats, col),
                                      np.asarray(getattr(ref.stats, col)),
                                      err_msg=col)
    for col in ("divergence", "drift"):
        np.testing.assert_allclose(getattr(port.stats, col),
                                   np.asarray(getattr(ref.stats, col)),
                                   rtol=2e-3, atol=1e-4, err_msg=col)
    assert port.stats.strikes.sum() > port.stats.faults.sum()


# ---------------------------------------------------------------------------
# (c) the paged run's own behaviour
# ---------------------------------------------------------------------------


def test_paged_churn_cancels_in_flight():
    """A departure cancels the client's dispatch on the spot: after every
    tick no unavailable client holds a finite completion time, and every
    dispatch lies in the mask the tick selected under."""
    exp = build_experiment(ExperimentSpec(
        **dict(TINY, selection="stochastic-sched"), **PAGED,
        churn_leave=0.4, churn_join=0.4), device="cpu")
    assert exp.stats is exp.store.stats
    exp.run(rounds=1)
    for _ in range(4):
        h = exp.run(rounds=1, include_initial_round=False)
        avail = set(np.flatnonzero(exp.stats.avail).tolist())
        assert {int(i) for i in h.selected[-1]} <= avail
        assert np.isinf(exp.stats.t_done[~exp.stats.avail]).all()


def test_paged_async_state_persists_across_runs():
    """The clock continues through the stats table; fired folds keep the
    divergence and drift columns (drift 0 on a fired or untouched client,
    ≥ 0 everywhere); the fired rows left the device staging."""
    exp = _preset_clusters(build_experiment(ExperimentSpec(**TINY, **PAGED),
                                            device="cpu"))
    assert float(exp.stats.t_now) == 0.0
    h1 = exp.run(rounds=2, include_initial_round=False)
    t1 = float(exp.stats.t_now)
    assert t1 > 0.0 and sum(h1.participation) > 0
    assert exp.stats.divergence.max() > 0.0
    assert (exp.stats.drift >= 0.0).all()
    assert (exp.stats.drift[~exp.store.touched] == 0.0).all()
    staged = set(exp.store._staged)
    assert staged == set(np.flatnonzero(np.isfinite(exp.stats.t_done)))
    exp.run(rounds=1, include_initial_round=False)
    assert float(exp.stats.t_now) > t1


def test_async_paged_target_accuracy_early_stop():
    """A host loop, so ``target_accuracy`` stops it (the dense engine
    refuses a target)."""
    exp = _preset_clusters(build_experiment(ExperimentSpec(**TINY, **PAGED),
                                            device="cpu"))
    h = exp.run(rounds=TINY["rounds"], target_accuracy=0.01,
                include_initial_round=False)
    assert h.rounds_to_target == 1 and len(h.accuracy) == 1
    assert len(h.participation) == 1 and len(h.seconds) == 1


def test_paged_async_carries_no_plane():
    """The paged carry is the global row and the stats table: no ``[N,
    P]`` plane exists on the device, and the initial round runs only when
    the selector needs clusters."""
    exp = build_experiment(ExperimentSpec(**TINY, **PAGED), device="cpu")
    state = exp.traced_state()
    assert state.client_params is None and state.sched is not None
    h = exp.run(rounds=2, include_initial_round=False)
    assert exp.clusters is None and len(h.accuracy) == 2
    with pytest.raises(AttributeError, match="paged"):
        exp.client_plane
