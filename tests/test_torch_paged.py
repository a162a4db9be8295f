"""The paged client store's host loop (``store="paged"``) in the port.

Inside the port, bit for bit: the paged run with ``div_refresh_every=1``
and ``chunk_size`` < N equals the dense host loop from the same seed
(selections, T_k/E_k, accuracy, global row, divergences, client tree,
features), and lazy data equals the materialized partition. Against the
reference's paged run, on the reference's draws: selections equal, T_k
and E_k within SAO's band (rtol 2e-3), the global row within atol 1e-4
— with the exact refresh, and with the initial round in waves
(``k_max`` < N) and the minibatch K-means. Then the waves' streaming
mean, the drift bound, churn, the no-op round, every refusal and the
spec's new fields."""
import torch_threads  # noqa: F401  (first: one torch thread)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as RefSpec
from repro.api import build_experiment as ref_build_experiment
from repro.utils.trees import tree_flatten_vector

import repro_torch.api.build as build
from repro_torch.api import ExperimentSpec, build_experiment, build_cohort
from repro_torch.api.scenario import FleetSpec
from repro_torch.core.fedavg import FLExperiment
from repro_torch.data.partition import partition_bias_lazy
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import ops

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_slice import JaxReplayDraws  # noqa: E402

SPEC = dict(dataset="fashion", clients=12, samples_per_client=16,
            train_samples=300, test_samples=80, local_iters=2, batch_size=8,
            devices_per_round=4, num_clusters=3, rounds=3)
EXACT = dict(store="paged", chunk_size=5, div_refresh_every=1)
WAVES = dict(store="paged", k_max=5, chunk_size=4, cluster="minibatch")


def _paged(device="cpu", **kw):
    return build_experiment(ExperimentSpec(**SPEC, **dict(EXACT, **kw)),
                            device=device)


@pytest.fixture(scope="module")
def dense_run():
    exp = build_experiment(ExperimentSpec(**SPEC), device="cpu")
    return exp, exp._run_host(None, SPEC["rounds"], 0.0)


@pytest.fixture(scope="module")
def paged_run():
    exp = _paged()
    return exp, exp.run()


def test_paged_history_equals_the_dense_host_loop(dense_run, paged_run):
    (_, hd), (_, hp) = dense_run, paged_run
    assert len(hp.selected) == SPEC["rounds"] + 1
    for a, b in zip(hd.selected, hp.selected):
        np.testing.assert_array_equal(a, b)
    assert hp.T_k == hd.T_k and hp.E_k == hd.E_k
    assert hp.accuracy == hd.accuracy and hp.band_mhz == hd.band_mhz


def test_paged_global_row_and_divergences_bitwise(dense_run, paged_run):
    (d, _), (p, _) = dense_run, paged_run
    torch.testing.assert_close(p.global_vec, d.global_vec, rtol=0, atol=0)
    np.testing.assert_array_equal(p.divergences(), d.divergences())


def test_paged_client_tree_and_features_bitwise(dense_run, paged_run):
    (d, _), (p, _) = dense_run, paged_run
    want, got = d.client_tree(), p.client_tree(chunk_size=5)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    for layer in ("all", "auto", "w_fc2"):
        torch.testing.assert_close(p.client_features(layer, chunk_size=5),
                                   d.client_features(layer), rtol=0, atol=0)


def test_iterators_cover_the_store(paged_run):
    p, _ = paged_run
    rows = np.concatenate(list(p.store.iter_chunks(5)))
    blocks = list(p.iter_client_features("all", chunk_size=5))
    assert [s for s, _ in blocks] == [0, 5, 10]
    np.testing.assert_array_equal(np.concatenate([b for _, b in blocks]),
                                  rows)
    spec = p.flat_spec
    trees = list(p.iter_client_trees(chunk_size=7))
    got = np.concatenate([np.concatenate(
        [t[n].reshape(t[n].shape[0], -1) for n in spec.names], axis=1)
        for _, t in trees])
    np.testing.assert_array_equal(got, rows)


def test_stats_table_after_the_exact_run(paged_run):
    p, hist = paged_run
    st = p.stats
    assert p.store.num_touched == SPEC["clients"]
    assert np.all(st.age[hist.selected[-1]] == 0)
    assert st.age.max() == SPEC["rounds"] and st.avail.all()
    rows = np.concatenate(list(p.store.iter_chunks()))
    true = np.linalg.norm(rows - p.global_vec.numpy()[None], axis=1)
    np.testing.assert_allclose(p.divergences(), true, rtol=1e-5)
    assert (st.drift == 0).all()            # refreshed every round


@pytest.mark.parametrize("extra", [EXACT, WAVES], ids=["exact", "waves"])
def test_paged_run_against_the_reference(extra):
    ref = ref_build_experiment(RefSpec(**SPEC, **extra))
    h_r = ref.run("divergence")
    port = build_experiment(ExperimentSpec(**SPEC, **extra), device="cpu",
                            draws=JaxReplayDraws(0))
    h_p = port.run()
    for a, b in zip(h_r.selected, h_p.selected):
        np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_allclose(h_p.T_k, h_r.T_k, rtol=2e-3)
    np.testing.assert_allclose(h_p.E_k, h_r.E_k, rtol=2e-3)
    np.testing.assert_allclose(port.global_vec.numpy(),
                               np.asarray(tree_flatten_vector(
                                   ref.global_params)), atol=1e-4)
    np.testing.assert_array_equal(port.cluster_labels, ref.cluster_labels)
    np.testing.assert_allclose(port.divergences(), ref.divergences(),
                               atol=1e-4)
    assert port.store.num_touched == ref.store.num_touched


def test_waves_stream_the_eq4_mean_and_bound_the_drift():
    exp = build_experiment(ExperimentSpec(**SPEC, **WAVES), device="cpu")
    exp.initial_round()
    assert exp.store.num_touched == SPEC["clients"]
    assert len(exp.cluster_labels) == SPEC["clients"]
    rows = np.concatenate(list(exp.store.iter_chunks()))
    want = ops.flat_aggregate(torch.tensor(rows),
                              torch.tensor(exp.fed.sizes,
                                           dtype=torch.float32))
    torch.testing.assert_close(exp.global_vec, want, rtol=1e-5, atol=1e-6)
    exp._run_host("divergence", 3, 0.0, include_initial_round=False)
    rows = np.concatenate(list(exp.store.iter_chunks()))
    true = np.linalg.norm(rows - exp.global_vec.numpy()[None], axis=1)
    st = exp.stats
    assert (st.drift > 0).any()             # div_refresh_every = 0: stale
    assert np.all(np.abs(true - st.divergence) <= st.drift + 1e-4)


def test_lazy_data_equals_the_materialized_partition(monkeypatch):
    monkeypatch.setattr(build, "LAZY_PARTITION_MIN", 1)
    lazy = _paged()
    monkeypatch.setattr(build, "LAZY_PARTITION_MIN", 50_000)
    mat = _paged()
    assert lazy.fed.lazy and not mat.fed.lazy
    h_l, h_m = lazy.run(rounds=2), mat.run(rounds=2)
    assert h_l.accuracy == h_m.accuracy and h_l.T_k == h_m.T_k
    torch.testing.assert_close(lazy.global_vec, mat.global_vec, rtol=0,
                               atol=0)


def test_departed_client_keeps_its_cold_row():
    exp = _paged()
    exp.initial_round()
    gone = 3
    frozen = exp.store.row(gone).copy()
    exp.stats.avail[gone] = False
    for _ in range(2):
        res = exp.round("divergence")
        assert gone not in res.selected
    np.testing.assert_array_equal(exp.store.row(gone), frozen)
    exp.stats.avail[gone] = True             # rejoins: the same row
    np.testing.assert_array_equal(exp.store.gather([gone]).numpy()[0],
                                  frozen)


def test_churned_out_fleet_is_a_noop_round():
    exp = _paged()
    exp.initial_round()
    before = exp.global_vec.clone()
    touched = exp.store.touched.copy()
    exp.stats.avail[:] = False
    res = exp.round("divergence")
    assert res.selected.size == 0 and res.T_k == 0.0 and res.E_k == 0.0
    torch.testing.assert_close(exp.global_vec, before, rtol=0, atol=0)
    np.testing.assert_array_equal(exp.store.touched, touched)


def test_churned_run_skips_the_initial_round():
    exp = build_experiment(ExperimentSpec(
        **SPEC, store="paged", selection="random", churn_leave=0.2,
        churn_join=0.6), device="cpu")
    assert exp.churn == (0.2, 0.6)
    hist = exp.run(rounds=4, include_initial_round=False)
    assert len(hist.accuracy) == 4 and exp.clusters is None
    assert all(len(s) <= SPEC["devices_per_round"] for s in hist.selected)
    assert exp.store.num_touched <= 4 * SPEC["devices_per_round"]
    assert not exp.stats.avail.all()
    # a selector that needs clusters gets its initial round
    hist = exp.run("divergence", rounds=1, include_initial_round=False)
    assert len(hist.selected) == 2 and exp.clusters is not None


def test_paged_refusals(paged_run):
    p, _ = paged_run
    with pytest.raises(AttributeError, match="client_tree"):
        p.client_plane
    with pytest.raises(AttributeError, match="scatter"):
        p.client_plane = torch.zeros(1)
    ds = make_dataset("fashion", 300, seed=0)
    lazy = partition_bias_lazy(ds, 12, 16, 0.8, seed=1)
    args = (p.model_cfg, lazy, p.test_images.numpy(), p.test_labels.numpy(),
            p.fleet, p.fl)
    with pytest.raises(ValueError, match="store='paged'"):
        FLExperiment(*args, device="cpu")
    with pytest.raises(ValueError, match="churn"):
        FLExperiment(*args[:1], p.fed, *args[2:], device="cpu",
                     churn=(0.1, 0.0))
    with pytest.raises(ValueError, match="cluster must be"):
        FLExperiment(*args, device="cpu", store="paged", cluster="kmeans")
    fading = ExperimentSpec(**SPEC, **EXACT,
                            fleet=FleetSpec(channel="gauss-markov:0.9"))
    with pytest.raises(ValueError, match="store='paged'"):
        build_experiment(fading, device="cpu").run()
    # a robust fold, once refused, builds on the paged store
    robust = build_experiment(ExperimentSpec(**SPEC, **EXACT,
                                             aggregator="trimmed:0.2"),
                              device="cpu")
    assert robust.aggregator.registry_name == "trimmed"
    with pytest.raises(ValueError, match="paged"):
        build_cohort(ExperimentSpec(**SPEC, **EXACT), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("store", "sharded"), ("k_max", 0), ("chunk_size", -1),
    ("div_refresh_every", -1), ("cluster", "kmeans"),
    ("churn_leave", 1.5), ("churn_join", -0.1)])
def test_spec_validates_the_store_fields(field, value):
    with pytest.raises(ValueError, match=field if field != "store"
                       else "store="):
        ExperimentSpec(**{field: value})


def test_spec_round_trips_the_store_fields():
    spec = ExperimentSpec(**SPEC, store="paged", k_max=6, chunk_size=3,
                          div_refresh_every=2, cluster="minibatch",
                          churn_leave=0.1, churn_join=0.3)
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert spec.to_dict()["store"] == "paged"
    assert spec.to_dict()["p_shards"] == 0       # every reference field
    exp = build_experiment(spec, device="cpu")
    assert (exp.k_max, exp.chunk_size, exp._div_refresh_every,
            exp.cluster_mode, exp.churn) == (6, 3, 2, "minibatch",
                                             (0.1, 0.3))
    default = build_experiment(ExperimentSpec(**SPEC, store="paged"),
                               device="cpu")
    assert default.k_max == SPEC["clients"]      # min(N, max(S, 256))
    assert default.chunk_size == 859             # 64 MB of fashion rows
