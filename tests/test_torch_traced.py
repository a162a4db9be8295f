"""The port's device-resident run (``FLExperiment.run`` on the traced
path, ``core/engine.py::run_rounds``) and its strategy contracts, on the
CPU, where the round body runs eagerly.

(a) each ``select_traced`` against the reference's on the same inputs —
    the stochastic ones fed the reference's own ``jax.random`` uniforms or
    permutation — ``idx`` and ``mask`` equal, ties and a cluster smaller
    than s included;
(b) each ``allocate_traced`` against the reference's, padded and unpadded,
    within the ROADMAP's bands (SAO rtol 2e-3, equal 1e-4, the FEDL grid
    1e-2 with its objective 1e-3);
(c) the traced ``run()`` ≡ the host loop on the port (selections equal,
    T/E rtol 1e-6, accuracy equal, global row atol 1e-6, labels and the
    draws' generator state equal) when every selection is full;
(d) the port's traced ``run()`` against the reference's, replaying its key
    stream, at ``test_torch_slice.py``'s tolerances;
(e) a padded round leaves the unselected clients' rows untouched;
(f) an accuracy target and the stochastic selectors take the host loop,
    and the traced run refuses a stochastic selector naming the port;
(g) FedProx's local update against the reference's at μ = 0.01, and
    traced ≡ host with ``fedprox_mu > 0``.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ALLOCATORS as REF_ALLOCATORS
from repro.api import ExperimentSpec as RefSpec
from repro.api import SELECTORS as REF_SELECTORS
from repro.api import build_experiment as ref_build_experiment
from repro.api.protocols import TracedContext as RefTracedContext
from repro.configs.paper_cnn import CNN_CONFIGS as REF_CNN_CONFIGS
from repro.core.algorithms import make_fedprox_local_update as ref_fedprox
from repro.core.wireless import fleet_arrays as ref_fleet_arrays
from repro.core.wireless import sample_fleet as ref_sample_fleet
from repro.models.cnn import init_cnn as ref_init_cnn
from repro.utils.trees import tree_flatten_vector

from repro_torch.api import (AGGREGATORS, ALLOCATORS, SELECTORS,
                             ExperimentSpec, build_experiment)
from repro_torch.api.protocols import (RoundState, TracedAllocator,
                                       TracedContext, TracedSelector)
from repro_torch.configs.paper_cnn import CNN_CONFIGS
from repro_torch.core import engine
from repro_torch.core.algorithms import make_fedprox_local_update
from repro_torch.core.wireless import fleet_arrays, sample_fleet
from repro_torch.utils.trees import params_from_jax

from test_torch_slice import SPEC, JaxReplayDraws

TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=3, devices_per_round=4, num_clusters=4,
            learning_rate=0.05)
N, C, S, s = 12, 3, 5, 2


# ---------------------------------------------------------------------------
# (a) the traced selectors
# ---------------------------------------------------------------------------


def _selector_inputs(seed):
    """Labels with a one-member cluster (smaller than s = 2), divergences
    with ties inside a cluster, the fleet's arrays, both contexts."""
    rng = np.random.default_rng(seed)
    labels = np.array([0, 1, 0, 1, 0, 1, 2, 0, 1, 0, 1, 0])
    div = rng.gamma(2.0, 1.0, N).astype(np.float32)
    div[[2, 4]] = div[0] = np.float32(div.max() + 1.0)  # a three-way tie
    div[[3, 5]] = div[1]
    fleet = sample_fleet(N, seed=seed)
    port = dict(div=torch.tensor(div), labels=torch.tensor(labels),
                arr=fleet_arrays(fleet),
                ctx=TracedContext(N, S, s, C, 20.0))
    ref = dict(div=jnp.asarray(div), labels=jnp.asarray(labels, jnp.int32),
               arr=ref_fleet_arrays(ref_sample_fleet(N, seed=seed)),
               ctx=RefTracedContext(N, S, s, C, 20.0))
    return port, ref


def _draw(name, key):
    """The reference's own draw inside its ``select_traced``."""
    if name == "random":
        return torch.tensor(np.asarray(jax.random.permutation(key, N)))
    if name in ("kmeans_random", "stochastic-sched", "rra", "rra:5"):
        return torch.tensor(np.asarray(jax.random.uniform(key, (N,))))
    return None


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["divergence", "kmeans_random", "random",
                                  "icas", "icas:0.3", "stochastic-sched",
                                  "rra", "rra:5"])
def test_traced_selector_matches_reference(name, seed):
    port, ref = _selector_inputs(seed)
    got_sel, want_sel = SELECTORS.resolve(name), REF_SELECTORS.resolve(name)
    assert got_sel.traceable and isinstance(got_sel, TracedSelector)
    assert got_sel.pad_size(port["ctx"]) == want_sel.pad_size(ref["ctx"])
    key = jax.random.PRNGKey(10 + seed)
    want_idx, want_mask = want_sel.select_traced(
        key if want_sel.needs_rng else None, ref["div"], ref["labels"],
        ref["arr"], ref["ctx"])
    got_idx, got_mask = got_sel.select_traced(
        _draw(name, key), port["div"], port["labels"], port["arr"],
        port["ctx"])
    assert got_idx.dtype == torch.int64
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


# x86 arithmetic's NaN (inf·0, NaN propagated): the sign bit set
X86_NAN = np.uint32(0xFFC00000).view(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["divergence", "icas", "icas:0.3"])
def test_traced_selector_ranks_nan_as_the_reference(name, seed):
    """A non-finite client row's divergence is x86's NaN: ``lax.top_k``
    ranks it below −inf, so the next member wins its cluster (and a NaN
    winner of a one-member cluster is masked); the port ranks every NaN
    there too (a ``torch.sort`` puts NaN first and would mask the
    cluster). Signed zeros and ±inf rank as the reference's total order.
    Under ICAS a NaN divergence makes every score NaN (the max over the
    fleet normalises them), on both sides alike."""
    port, ref = _selector_inputs(seed)
    div = port["div"].numpy().copy()
    div[[0, 6, 9]] = X86_NAN              # 6 is the one-member cluster
    div[1], div[3], div[10] = np.inf, -0.0, 0.0
    port["div"], ref["div"] = torch.tensor(div), jnp.asarray(div)
    got_sel, want_sel = SELECTORS.resolve(name), REF_SELECTORS.resolve(name)
    want_idx, want_mask = want_sel.select_traced(
        None, ref["div"], ref["labels"], ref["arr"], ref["ctx"])
    got_idx, got_mask = got_sel.select_traced(
        None, port["div"], port["labels"], port["arr"], port["ctx"])
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    if name == "divergence":
        assert 0 not in got_idx[got_mask].tolist()


def test_stable_top_is_lax_top_k_total_order():
    from repro_torch.strategies.traced import _stable_top
    rng = np.random.default_rng(0)
    x = rng.choice(np.asarray([X86_NAN, np.inf, -np.inf, 0.0, -0.0, 1.0,
                               -1.0, 2.5], np.float32), size=(3, 40))
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 17)
    got_v, got_i = _stable_top(torch.tensor(x), 17)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy().view(np.uint32),
                                  np.asarray(want_v).view(np.uint32))


# the asynchronous engine's churn mask: most devices gone, so a cluster
# (and ICAS's top S) runs out of available devices
AVAIL_MASKS = {"few": [0, 3, 4, 9], "none": [], "all": list(range(N))}


@pytest.mark.parametrize("avail", sorted(AVAIL_MASKS))
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["divergence", "icas", "icas:0.3",
                                  "stochastic-sched", "kmeans_random",
                                  "random", "rra"])
def test_traced_selector_with_churn_mask_matches_reference(name, seed,
                                                          avail):
    """``arr["avail"]`` (1.0 / 0.0): the divergence and ICAS policies rank
    only available devices (an unavailable winner points at the sentinel
    and is masked), stochastic scheduling never draws one; the other
    policies ignore the key, as the reference's do."""
    port, ref = _selector_inputs(seed)
    a = np.zeros(N, np.float32)
    a[AVAIL_MASKS[avail]] = 1.0
    port["arr"] = dict(port["arr"], avail=torch.tensor(a))
    ref["arr"] = dict(ref["arr"], avail=jnp.asarray(a))
    got_sel, want_sel = SELECTORS.resolve(name), REF_SELECTORS.resolve(name)
    key = jax.random.PRNGKey(20 + seed)
    want_idx, want_mask = want_sel.select_traced(
        key if want_sel.needs_rng else None, ref["div"], ref["labels"],
        ref["arr"], ref["ctx"])
    got_idx, got_mask = got_sel.select_traced(
        _draw(name, key), port["div"], port["labels"], port["arr"],
        port["ctx"])
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    if name in ("divergence", "icas", "icas:0.3") or (
            name == "stochastic-sched" and avail != "none"):
        assert set(got_idx[got_mask].tolist()) <= set(AVAIL_MASKS[avail])


def test_churn_mask_keeps_ties_in_index_order():
    """Sunk devices sort last among −inf ties in index order (the stable
    descending sort), and are marked invalid: lanes 1 and 3 of ``[3, 1, 3,
    2, 3]`` left, so the cluster's top 2 are lanes 0 and 2 and a third slot
    would get none."""
    sel = SELECTORS.resolve("divergence")
    ctx = TracedContext(5, 6, 3, 2, 20.0)
    arr = {"avail": torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0])}
    idx, mask = sel.select_traced(None, torch.tensor([3.0, 1, 3, 2, 3]),
                                  torch.zeros(5, dtype=torch.long), arr, ctx)
    assert idx.tolist() == [0, 2, 5, 5, 5, 5]
    assert mask.tolist() == [True, True, False, False, False, False]


def test_ties_go_to_the_lower_index_and_small_clusters_pad():
    """On ``[3, 1, 3, 2, 3]`` in one cluster the top 2 are lanes 0 and 2
    (``lax.top_k``; ``torch.topk`` gives 2 and 4); the empty cluster pads
    with the sentinel N."""
    sel = SELECTORS.resolve("divergence")
    ctx = TracedContext(5, 4, 2, 2, 20.0)
    idx, mask = sel.select_traced(None, torch.tensor([3.0, 1, 3, 2, 3]),
                                  torch.zeros(5, dtype=torch.long), None,
                                  ctx)
    assert idx.tolist() == [0, 2, 5, 5]
    assert mask.tolist() == [True, True, False, False]


# ---------------------------------------------------------------------------
# (b) the traced allocators
# ---------------------------------------------------------------------------

RTOL = {"sao": 2e-3, "sao:box": 2e-3, "equal": 1e-4, "fedl:4.58": 1e-2,
        "fedl_auto": 1e-2}
ALLOCATOR_CASES = ["sao", "sao:box", "equal", "fedl:4.58",
                   {"name": "fedl_auto", "params": {"iters": 4,
                                                    "n_grid": 30}}]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("name", ALLOCATOR_CASES, ids=str)
def test_traced_allocator_matches_reference(name, padded, seed):
    fleet = sample_fleet(100, seed=seed)
    ref_fleet = ref_sample_fleet(100, seed=seed)
    idx = np.array([3, 17, 42, 8, 61, 29, 100, 100] if padded
                   else [3, 17, 42, 8, 61, 29, 77, 90])
    mask = idx < 100
    # the padding lanes carry device N − 1's constants, as the round
    # gathers them at the clamped sentinel
    arr = fleet_arrays(fleet.select(np.minimum(idx, 99)))
    ref_arr = ref_fleet_arrays(ref_fleet.select(np.minimum(idx, 99)))
    got_alloc, want_alloc = (ALLOCATORS.resolve(name),
                             REF_ALLOCATORS.resolve(name))
    assert got_alloc.traceable and isinstance(got_alloc, TracedAllocator)
    T, E, b, f = got_alloc.allocate_traced(
        arr, 20.0, torch.tensor(mask) if padded else None)
    Tr, Er, br, fr = want_alloc.allocate_traced(
        ref_arr, 20.0, jnp.asarray(mask) if padded else None)
    key = name if isinstance(name, str) else name["name"]
    rtol = RTOL[key]
    np.testing.assert_allclose(float(T), float(Tr), rtol=rtol)
    np.testing.assert_allclose(float(E), float(Er), rtol=rtol)
    if key == "fedl:4.58":
        np.testing.assert_allclose(float(E) + 4.58 * float(T),
                                   float(Er) + 4.58 * float(Tr), rtol=1e-3)
    if padded:
        assert float(b[~torch.tensor(mask)].abs().max()) == 0.0
        assert float(f[~torch.tensor(mask)].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# (c) traced run ≡ host loop on the port
# ---------------------------------------------------------------------------


def _host(exp, rounds, **kw):
    """The host loop, whatever ``run()`` would pick."""
    return exp._run_host(None, rounds, 0.0, **kw)


def _assert_same_runs(exp_t, h_t, exp_h, h_h, pad):
    assert len(h_t.selected) == len(h_h.selected)
    for a, b in zip(h_t.selected[1:], h_h.selected[1:]):
        assert len(a) == pad, "parity holds for full selections only"
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(h_t.selected[0], h_h.selected[0])
    np.testing.assert_allclose(h_t.T_k, h_h.T_k, rtol=1e-6)
    np.testing.assert_allclose(h_t.E_k, h_h.E_k, rtol=1e-6)
    np.testing.assert_allclose(h_t.band_mhz, h_h.band_mhz, rtol=1e-6)
    assert h_t.accuracy == h_h.accuracy
    for a, b in zip(h_t.per_class, h_h.per_class):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(exp_t.global_vec.numpy(),
                               exp_h.global_vec.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(exp_t.client_plane.numpy(),
                               exp_h.client_plane.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(exp_t.cluster_labels, exp_h.cluster_labels)
    assert torch.equal(exp_t.draws.generator.get_state(),
                       exp_h.draws.generator.get_state())


@pytest.mark.parametrize("allocator", ["sao", "equal"])
def test_traced_run_matches_the_host_loop(allocator):
    spec = ExperimentSpec(**TINY, allocator=allocator)
    traced = build_experiment(spec, device="cpu")
    assert traced.traceable()
    h_t = traced.run()
    host = build_experiment(spec, device="cpu")
    h_h = _host(host, spec.rounds)
    assert h_t.seconds == [] and len(h_h.seconds) == spec.rounds + 1
    assert all(type(x) is float for x in h_t.accuracy + h_t.T_k + h_t.E_k)
    _assert_same_runs(traced, h_t, host, h_h, spec.devices_per_round)
    # a second run continues from the synced-back state on both paths
    h_t2 = traced.run(rounds=2, include_initial_round=False)
    h_h2 = _host(host, 2, include_initial_round=False)
    assert len(h_t2.accuracy) == 2
    _assert_same_runs(traced, h_t2, host, h_h2, spec.devices_per_round)


@pytest.mark.parametrize("model", ["tinyllama", "mamba2-130m"])
def test_traced_lm_run_matches_the_host_loop(model):
    """The LoRA LM's rows (frozen base beside the plane) on both paths."""
    spec = ExperimentSpec(model=model, clients=6, train_samples=48,
                          test_samples=16, samples_per_client=8,
                          devices_per_round=2, num_clusters=2, local_iters=2,
                          batch_size=4, rounds=2, learning_rate=0.1)
    traced, host = (build_experiment(spec, device="cpu") for _ in range(2))
    h_t = traced.run()
    assert h_t.seconds == []
    _assert_same_runs(traced, h_t, host, _host(host, 2),
                      spec.devices_per_round)


def test_traced_run_icas_matches_the_host_loop():
    """ICAS is deterministic, so run() takes the traced path for it."""
    spec = ExperimentSpec(**TINY, selection="icas")
    traced, host = (build_experiment(spec, device="cpu") for _ in range(2))
    h_t = traced.run(rounds=2)
    assert h_t.seconds == []
    h_h = _host(host, 2)
    for a, b in zip(h_t.selected, h_h.selected):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(h_t.T_k, h_h.T_k, rtol=1e-6)
    np.testing.assert_allclose(traced.global_vec.numpy(),
                               host.global_vec.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# (d) port traced vs reference traced
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_and_port_traced():
    ref = ref_build_experiment(RefSpec(**SPEC))
    assert ref.traceable()
    h_ref = ref.run()
    port = build_experiment(ExperimentSpec(**SPEC), device="cpu",
                            draws=JaxReplayDraws(0))
    h_port = port.run()
    assert h_port.seconds == []               # the traced path ran
    return ref, h_ref, port, h_port


def test_traced_run_matches_reference_selections(ref_and_port_traced):
    _, h_ref, _, h_port = ref_and_port_traced
    assert len(h_port.selected) == len(h_ref.selected) == SPEC["rounds"] + 1
    for a, b in zip(h_port.selected, h_ref.selected):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_traced_run_matches_reference_T_E_accuracy(ref_and_port_traced):
    _, h_ref, _, h_port = ref_and_port_traced
    np.testing.assert_allclose(h_port.T_k, h_ref.T_k, rtol=2e-3)
    np.testing.assert_allclose(h_port.E_k, h_ref.E_k, rtol=2e-3)
    for a, b in zip(h_port.accuracy, h_ref.accuracy):
        assert abs(a - b) <= 1.0 / SPEC["test_samples"] + 1e-6


def test_traced_run_matches_reference_state(ref_and_port_traced):
    ref, _, port, _ = ref_and_port_traced
    np.testing.assert_allclose(
        port.global_vec.numpy(),
        np.asarray(tree_flatten_vector(ref.global_params)), atol=1e-4)
    np.testing.assert_allclose(port.client_plane.numpy(),
                               np.asarray(ref.client_params), atol=1e-4)
    np.testing.assert_array_equal(port.cluster_labels,
                                  np.asarray(ref.cluster_labels))


# ---------------------------------------------------------------------------
# (e) padded rounds
# ---------------------------------------------------------------------------


def test_padded_round_leaves_unselected_rows_untouched():
    """s = 3 of clusters that are mostly smaller: 12 lanes over 8
    clients, the rest padding. Only the selected rows change, and the
    global row is the fold of the selected rows alone."""
    spec = ExperimentSpec(**dict(TINY, selected_per_cluster=3))
    exp = build_experiment(spec, device="cpu")
    exp.run(rounds=1)
    before = exp.client_plane.clone()
    hist = exp.run(rounds=1, include_initial_round=False)
    assert hist.seconds == []
    sel = hist.selected[0]
    assert 0 < len(sel) < 12 and len(set(sel.tolist())) == len(sel)
    assert exp.client_plane.shape == before.shape
    others = np.setdiff1d(np.arange(spec.clients), sel)
    assert torch.equal(exp.client_plane[others], before[others])
    assert not torch.equal(exp.client_plane[sel], before[sel])
    w = exp._sizes[torch.tensor(sel)].to(torch.float32)
    want = (w[:, None] * exp.client_plane[sel]).sum(0) / w.sum()
    np.testing.assert_allclose(exp.global_vec.numpy(), want.numpy(),
                               atol=1e-6)


def test_round_body_writes_padding_lanes_past_the_clients():
    """The carry's plane has one row per padding lane after the N client
    rows; a padded round writes its padding lanes there and nowhere
    else."""
    spec = ExperimentSpec(**dict(TINY, selected_per_cluster=3))
    exp = build_experiment(spec, device="cpu")
    exp.run(rounds=1)
    state = exp.traced_state()
    assert isinstance(state, RoundState)
    assert tuple(state.client_params.shape) == (8 + 12, exp.global_vec.numel())
    res = exp.traced_run(exp.selector, 1, include_initial_round=False)
    mask = res.rounds.mask[0]
    assert int(mask.sum()) < 12
    pads = 8 + torch.nonzero(~mask)[:, 0]
    assert torch.count_nonzero(res.state.client_params[pads]) > 0
    assert torch.equal(res.state.labels, torch.as_tensor(exp.cluster_labels))


# ---------------------------------------------------------------------------
# (f) which path run() takes
# ---------------------------------------------------------------------------


def test_target_accuracy_takes_the_host_loop():
    exp = build_experiment(ExperimentSpec(**TINY), device="cpu")
    hist = exp.run(rounds=2, target_accuracy=0.01)
    assert hist.rounds_to_target == 1 and len(hist.seconds) == 2


@pytest.mark.parametrize("selection", ["random", "kmeans_random", "rra",
                                       "stochastic-sched"])
def test_stochastic_selectors_take_the_host_loop(selection):
    spec = ExperimentSpec(**dict(TINY, selection=selection))
    exp = build_experiment(spec, device="cpu")
    assert exp.traceable()
    hist = exp.run(rounds=1)
    assert len(hist.seconds) == 2
    with pytest.raises(NotImplementedError, match="repro_torch"):
        exp.traced_run(exp.selector, 1)


def test_programs_are_cached_per_bundle_and_shape():
    a = build_experiment(ExperimentSpec(**TINY), device="cpu")
    b = build_experiment(ExperimentSpec(**dict(TINY, seed=3)), device="cpu")
    key = dict(selector=a.selector, allocator=a.allocator,
               aggregator=a.aggregator, tctx=a.traced_context(),
               feature_layer="auto", device="cpu", shapes=("x",))
    p = engine.run_rounds(a.engine_cfg, **key)
    assert engine.run_rounds(b.engine_cfg, **key) is p
    assert engine.run_rounds(a.engine_cfg, **dict(key, shapes=("y",))) is not p
    assert AGGREGATORS.resolve("fedavg").init_flat_state(None) is None


# ---------------------------------------------------------------------------
# (g) FedProx
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mu", [0.01, 0.5])
def test_fedprox_local_update_matches_reference(mu):
    dataset, n, d, L, batch, lr = "fashion", 3, 12, 3, 8, 0.05
    ref_p = {k: np.asarray(v) for k, v in ref_init_cnn(
        REF_CNN_CONFIGS[dataset], jax.random.PRNGKey(2)).items()}
    rng = np.random.default_rng(5)
    images = rng.normal(size=(n, d, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, (n, d)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(9), n)
    ref_update = jax.vmap(ref_fedprox(REF_CNN_CONFIGS[dataset], lr, L, batch,
                                      mu=mu), in_axes=(None, 0, 0, 0))
    want = ref_update({k: jnp.asarray(v) for k, v in ref_p.items()},
                      jnp.asarray(images), jnp.asarray(labels), keys)
    idx = np.stack([np.stack([
        np.asarray(jax.random.randint(k, (batch,), 0, d))
        for k in jax.random.split(key, L)]) for key in keys])
    got = make_fedprox_local_update(CNN_CONFIGS[dataset], lr, L, batch,
                                    mu=mu)(
        params_from_jax(ref_p), torch.tensor(images),
        torch.tensor(labels).long(), torch.tensor(idx, dtype=torch.long))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=1e-5,
                                   err_msg=k)


def test_fedprox_traced_run_matches_the_host_loop():
    spec = ExperimentSpec(**dict(TINY, fedprox_mu=0.01))
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    traced = build_experiment(spec, device="cpu")
    assert traced.engine_cfg.fedprox_mu == 0.01
    h_t = traced.run(rounds=2)
    host = build_experiment(spec, device="cpu")
    h_h = _host(host, 2)
    assert h_t.seconds == []
    _assert_same_runs(traced, h_t, host, h_h, spec.devices_per_round)
    plain = build_experiment(ExperimentSpec(**TINY), device="cpu")
    plain.run(rounds=2)
    assert not torch.equal(plain.global_vec, traced.global_vec)
