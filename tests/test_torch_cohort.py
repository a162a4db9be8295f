"""The port's seed cohorts (``build_cohort``, ``core/cohort.py``) on the
CPU, where the round body runs eagerly (on the card: one captured round
for every lane). The lane forms of the round body's functions, one by
one: ``tests/test_torch_lanes.py``.

(c) the port's cohort against the port's single runs of its seeds
    (``tests/test_traced_engine.py``'s cohort case): selections and
    accuracy equal, T_k/E_k rtol 1e-6, rows atol 1e-6 — with one test set
    for all lanes and with one a lane, and for the LoRA LM;
(d) the port's cohort against the reference's ``build_cohort``, each lane
    replaying its seed's reference key stream, at ``test_torch_slice.py``'s
    tolerances;
(e) the stochastic selectors in a cohort, their draws from each lane's
    draws object: a lane equals its seed's traced run fed the same draws,
    and the selections keep their invariants;
(f) ``CohortHistory.history(i)``'s layout, the refusals, and ``cohort`` in
    the spec's JSON form.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as RefSpec
from repro.api import build_cohort as ref_build_cohort

from repro_torch.api import ExperimentSpec, build_cohort, build_experiment
from repro_torch.core.cohort import CohortHistory

from test_torch_slice import JaxReplayDraws

TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=3, devices_per_round=4, num_clusters=4,
            learning_rate=0.05)
COHORT = dict(TINY, cohort=2, data_seed=7, test_seed=90_000)


# ---------------------------------------------------------------------------
# (c) the port's cohort against the port's single runs
# ---------------------------------------------------------------------------


def _assert_lane_is_single(ch, i, runner, single, h_single, rtol=1e-6):
    hi = ch.history(i)
    assert len(hi.selected) == len(h_single.selected)
    for a, b in zip(hi.selected, h_single.selected):
        np.testing.assert_array_equal(a, b)
    assert hi.accuracy == h_single.accuracy
    np.testing.assert_allclose(hi.T_k, h_single.T_k, rtol=rtol)
    np.testing.assert_allclose(hi.E_k, h_single.E_k, rtol=rtol)
    lane = runner.experiments[i]
    np.testing.assert_allclose(lane.global_vec.numpy(),
                               single.global_vec.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(lane.client_plane.numpy(),
                               single.client_plane.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(lane.cluster_labels, single.cluster_labels)


@pytest.mark.parametrize("selection", ["divergence", "icas"])
def test_cohort_matches_per_seed_runs(selection):
    spec = ExperimentSpec(**COHORT, selection=selection)
    runner = build_cohort(spec, device="cpu")
    ch = runner.run()
    assert ch.accuracy.shape == ch.T_k.shape == (2, TINY["rounds"] + 1)
    assert ch.selected.shape[:2] == (2, TINY["rounds"]) and len(ch) == 2
    for i, seed in enumerate(ch.seeds):
        single = build_experiment(spec.replace(seed=seed), device="cpu")
        h = single.run()
        assert h.seconds == []                  # the traced path ran
        _assert_lane_is_single(ch, i, runner, single, h)


def test_cohort_with_a_test_set_a_lane():
    """Seeds that resolve different test data: one stacked test set a
    lane, each lane evaluated on its own."""
    spec = ExperimentSpec(**dict(TINY, cohort=2, rounds=2), seed=3)
    runner = build_cohort(spec, device="cpu")
    ch = runner.run()
    assert ch.seeds == [3, 4]
    for i, seed in enumerate(ch.seeds):
        single = build_experiment(spec.replace(seed=seed), device="cpu")
        _assert_lane_is_single(ch, i, runner, single, single.run())


@pytest.mark.parametrize("model", ["tinyllama", "mamba2-130m"])
def test_lm_cohort_matches_per_seed_runs(model):
    """The LoRA LM's rows as lanes (the frozen base shared beside them)."""
    spec = ExperimentSpec(model=model, clients=6, train_samples=48,
                          test_samples=16, samples_per_client=8,
                          devices_per_round=2, num_clusters=2, local_iters=2,
                          batch_size=4, rounds=1, learning_rate=0.1,
                          cohort=2, test_seed=5)
    runner = build_cohort(spec, device="cpu")
    ch = runner.run()
    for i, seed in enumerate(ch.seeds):
        single = build_experiment(spec.replace(seed=seed), device="cpu")
        _assert_lane_is_single(ch, i, runner, single, single.run())


def test_cohort_continues_from_its_experiments():
    """``reuse_experiments`` runs the same lanes on from their loaded-back
    carries (a fresh initial round included, as the reference's)."""
    spec = ExperimentSpec(**dict(COHORT, rounds=1))
    runner = build_cohort(spec, device="cpu")
    runner.run()
    exps = list(runner.experiments)
    rows = [e.global_vec.clone() for e in exps]
    ch = runner.run(reuse_experiments=True)
    assert runner.experiments == exps and ch.accuracy.shape == (2, 2)
    assert not any(torch.equal(e.global_vec, r) for e, r in zip(exps, rows))


# ---------------------------------------------------------------------------
# (d) the port's cohort against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_and_port_cohorts():
    ref_runner = ref_build_cohort(RefSpec(**COHORT))
    ref_ch = ref_runner.run()
    port_runner = build_cohort(ExperimentSpec(**COHORT), device="cpu",
                               draws=JaxReplayDraws)
    return ref_runner, ref_ch, port_runner, port_runner.run()


def test_cohort_matches_reference_selections(ref_and_port_cohorts):
    _, ref_ch, _, ch = ref_and_port_cohorts
    assert ch.seeds == list(ref_ch.seeds)
    np.testing.assert_array_equal(ch.mask, np.asarray(ref_ch.mask))
    for i in range(len(ch)):
        for a, b in zip(ch.history(i).selected, ref_ch.history(i).selected):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_cohort_matches_reference_T_E_accuracy(ref_and_port_cohorts):
    _, ref_ch, _, ch = ref_and_port_cohorts
    np.testing.assert_allclose(ch.T_k, np.asarray(ref_ch.T_k), rtol=2e-3)
    np.testing.assert_allclose(ch.E_k, np.asarray(ref_ch.E_k), rtol=2e-3)
    np.testing.assert_allclose(ch.accuracy, np.asarray(ref_ch.accuracy),
                               rtol=0, atol=1.0 / TINY["test_samples"] + 1e-6)


def test_cohort_matches_reference_state(ref_and_port_cohorts):
    from repro.utils.trees import tree_flatten_vector
    ref_runner, _, port_runner, _ = ref_and_port_cohorts
    for r, p in zip(ref_runner.experiments, port_runner.experiments):
        np.testing.assert_allclose(
            p.global_vec.numpy(),
            np.asarray(tree_flatten_vector(r.global_params)), atol=1e-4)
        np.testing.assert_allclose(p.client_plane.numpy(),
                                   np.asarray(r.client_params), atol=1e-4)
        np.testing.assert_array_equal(p.cluster_labels,
                                      np.asarray(r.cluster_labels))


# ---------------------------------------------------------------------------
# (e) the stochastic selectors in a cohort
# ---------------------------------------------------------------------------


STOCHASTIC = dict(COHORT, rounds=2, selected_per_cluster=2)


@pytest.fixture(scope="module")
def stochastic_cohort():
    """``selection -> (spec, runner, history)``: one cohort a stochastic
    selector, run once for the module (s = 2, 2 rounds)."""
    runs = {}

    def run(selection):
        if selection not in runs:
            spec = ExperimentSpec(**STOCHASTIC, selection=selection)
            runner = build_cohort(spec, device="cpu")
            runs[selection] = spec, runner, runner.run()
        return runs[selection]
    return run


@pytest.mark.parametrize("selection", ["kmeans_random", "random", "rra",
                                       "stochastic-sched"])
def test_stochastic_lanes_equal_traced_runs_fed_the_same_draws(
        selection, stochastic_cohort):
    """The last lane (the one a lane offset would miss) against its
    seed's ``traced_run`` fed the seed's draws object (which ``run()``
    leaves to the host loop)."""
    spec, runner, ch = stochastic_cohort(selection)
    i = len(ch) - 1
    single = build_experiment(spec.replace(seed=ch.seeds[i]), device="cpu")
    res = single.traced_run(single.selector, spec.rounds, draws=single.draws)
    h = single.history_from_traced(res, spec.clients)
    single.load_traced_state(res.state)
    _assert_lane_is_single(ch, i, runner, single, h)


@pytest.mark.parametrize("selection", ["kmeans_random", "random"])
def test_stochastic_selections_keep_their_invariants(selection,
                                                     stochastic_cohort):
    """``kmeans_random``: at most s devices of a cluster a round;
    ``random``: exactly S distinct devices; all within range."""
    spec, runner, ch = stochastic_cohort(selection)
    draws_seen = set()
    for i in range(len(ch)):
        labels = runner.experiments[i].cluster_labels
        for sel in ch.history(i).selected[1:]:
            assert len(set(sel.tolist())) == len(sel)
            assert all(0 <= d < spec.clients for d in sel)
            if selection == "random":
                assert len(sel) == spec.devices_per_round
            else:
                assert np.bincount(labels[sel]).max() <= 2
            draws_seen.add(tuple(sel.tolist()))
    assert len(draws_seen) > 1                 # the draws differ by round


def test_traced_run_refuses_stochastic_selector_without_draws():
    exp = build_experiment(ExperimentSpec(**TINY, selection="random"),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="repro_torch"):
        exp.traced_run(exp.selector, 1)


# ---------------------------------------------------------------------------
# (f) the history's layout, the refusals, the spec
# ---------------------------------------------------------------------------


def test_cohort_history_has_the_reference_layout():
    ch = CohortHistory(
        seeds=[5, 6], accuracy=np.array([[0.1, 0.2], [0.3, 0.4]]),
        T_k=np.ones((2, 2)), E_k=np.full((2, 2), 2.0),
        selected=np.array([[[3, 1, 9]], [[0, 9, 9]]]),
        mask=np.array([[[True, True, False]], [[True, False, False]]]),
        with_init=True, num_devices=9)
    assert len(ch) == 2 and ch.lane_cells == [0, 0] and ch.cells == 1
    np.testing.assert_array_equal(ch.final_accuracy, [0.2, 0.4])
    h = ch.history(1)
    assert h.accuracy == [0.3, 0.4] and h.T_k == [1.0, 1.0]
    assert h.E_k == [2.0, 2.0] and h.seconds == []
    assert [s.tolist() for s in h.selected] == [list(range(9)), [0]]


def test_cohort_refuses_an_untraceable_bundle(monkeypatch):
    from repro_torch.strategies.allocators import SAOAllocator
    monkeypatch.setattr(SAOAllocator, "traceable", False)
    runner = build_cohort(ExperimentSpec(**COHORT), device="cpu")
    with pytest.raises(ValueError, match="all-traceable.*repro_torch"):
        runner.run()


def test_cohort_refuses_a_selector_it_lacks(monkeypatch):
    """A stochastic selector whose traced draw names no ``draw_kind``."""
    from repro_torch.strategies.selectors import RandomSelector
    monkeypatch.setattr(RandomSelector, "draw_kind", None)
    with pytest.raises(NotImplementedError, match="repro_torch"):
        build_cohort(ExperimentSpec(**COHORT, selection="random"),
                     device="cpu")


def test_cohort_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: build_cohort runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_cohort(ExperimentSpec(**COHORT))


def test_cohort_survives_the_json_round_trip():
    spec = ExperimentSpec(**COHORT)
    assert spec.to_dict()["cohort"] == 2
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert ExperimentSpec().cohort == 1
    assert build_cohort(spec, device="cpu").spec.cohort == 2
