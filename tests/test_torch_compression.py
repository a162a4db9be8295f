"""The port's uplink compression (``core/compression.py``,
``strategies/compressors.py``) and FedAvgM server momentum
(``core/algorithms.py::ServerMomentum``, ``strategies/aggregators.py``)
against the reference, on the CPU.

Tolerances: the compressors on the same padded ``[S_pad, P]`` rows are
bit-equal (held at atol 1e-7 first, so a failure reads as a size);
``payload_mbit`` is equal; the lane form
equals a loop of one-lane calls bit for bit. FedAvgM over 3 folds: v and
the row within atol 1e-6. The port against itself: host-loop momentum
continued by a traced run, and ``topk`` under the host loop against the
traced run — selections equal, T_k/E_k rtol 1e-6, rows atol 1e-6.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro.api import AGGREGATORS as REF_AGGREGATORS
from repro.api import COMPRESSORS as REF_COMPRESSORS
from repro.configs.paper_cnn import CNN_CONFIGS as REF_CNN
from repro.core.compression import payload_mbit as ref_payload_mbit
from repro.core.engine import model_flat_spec as ref_flat_spec
import jax.numpy as jnp

from repro_torch.api import AGGREGATORS, ExperimentSpec, build_experiment
from repro_torch.api.registry import COMPRESSORS
from repro_torch.configs.paper_cnn import CNN_CONFIGS
from repro_torch.core.compression import payload_mbit
from repro_torch.core.engine import model_flat_spec
from repro_torch.utils.trees import flatten_vector

TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=3, devices_per_round=4, num_clusters=4)


def _padded_rows(seed, s_real=4, s_pad=6, scale=0.01):
    """Client rows around a global row, the padding rows copies of the last
    real one (as the round body's clamped gather gives them)."""
    spec = model_flat_spec(CNN_CONFIGS["fashion"])
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 0.1, spec.total).astype(np.float32)
    rows = g + rng.normal(0, scale, (s_real, spec.total)).astype(np.float32)
    rows = np.concatenate([rows, np.repeat(rows[-1:], s_pad - s_real, 0)])
    return g, rows


@pytest.mark.parametrize("name", ["int8", "topk:0.05", "topk:0.01", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_flat_matches_the_reference(name, seed):
    g, rows = _padded_rows(seed)
    got = COMPRESSORS.resolve(name).apply_flat(
        torch.tensor(rows), torch.tensor(g),
        model_flat_spec(CNN_CONFIGS["fashion"])).numpy()
    want = np.asarray(REF_COMPRESSORS.resolve(name).apply_flat(
        jnp.asarray(rows), jnp.asarray(g), ref_flat_spec(REF_CNN["fashion"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got, want)
    if name.startswith("topk"):
        # the padding rows share the block's one threshold
        assert np.count_nonzero(got - g) <= got.size * float(
            name.split(":")[1]) + rows.shape[0] * 8


@pytest.mark.parametrize("params", [113_744, 19_522, 2, 10**6])
@pytest.mark.parametrize("scheme", ["none", "int8", "topk:0.01", "topk:0.3"])
def test_payload_mbit_equals_the_reference(params, scheme):
    assert payload_mbit(params, scheme, 8) == ref_payload_mbit(params,
                                                               scheme, 8)
    port = COMPRESSORS.resolve(scheme).payload_mbit(params, 8)
    ref = REF_COMPRESSORS.resolve(scheme).payload_mbit(params, 8)
    assert port == ref


@pytest.mark.parametrize("name", ["int8", "topk:0.05"])
def test_lane_form_is_a_loop_of_one_lane_calls(name):
    spec = model_flat_spec(CNN_CONFIGS["fashion"])
    lanes = [_padded_rows(s, scale=0.01 * (s + 1)) for s in range(3)]
    g = torch.tensor(np.stack([x[0] for x in lanes]))
    rows = torch.tensor(np.stack([x[1] for x in lanes]))
    comp = COMPRESSORS.resolve(name)
    got = comp.apply_flat(rows, g, spec)
    for b in range(3):
        assert torch.equal(got[b], comp.apply_flat(rows[b], g[b], spec))


def test_fedavgm_folds_match_the_reference():
    spec = model_flat_spec(CNN_CONFIGS["fashion"])
    port = AGGREGATORS.resolve("fedavgm:0.9")
    ref = REF_AGGREGATORS.resolve("fedavgm:0.9")
    rng = np.random.default_rng(5)
    g = rng.normal(0, 0.1, spec.total).astype(np.float32)
    g_p, v_p = torch.tensor(g), port.init_flat_state(torch.tensor(g))
    g_r = jnp.asarray(g)
    v_r = ref.init_flat_state(g_r)
    for k in range(3):
        rows = (g + rng.normal(0, 0.02, (5, spec.total))).astype(np.float32)
        w = rng.uniform(1, 3, 5).astype(np.float32)
        w[-1] = 0.0                                # a padding lane
        g_p, v_p = port.aggregate_flat(g_p, torch.tensor(rows),
                                       torch.tensor(w), v_p)
        g_r, v_r = ref.aggregate_flat(g_r, jnp.asarray(rows), jnp.asarray(w),
                                      v_r)
        np.testing.assert_allclose(v_p.numpy(), np.asarray(v_r), atol=1e-6)
        np.testing.assert_allclose(g_p.numpy(), np.asarray(g_r), atol=1e-6)
        g = g_p.numpy()
    # the momentum crosses to the host object and back unchanged
    port.load_flat_state(v_p, spec)
    assert torch.equal(port.init_flat_state(g_p), v_p)
    port.reset()
    assert not torch.any(port.init_flat_state(g_p))


def test_fedavgm_host_aggregate_is_the_flat_fold():
    """The host form (``aggregate`` over models) steps the same momentum
    as ``aggregate_flat`` over rows."""
    spec = model_flat_spec(CNN_CONFIGS["fashion"])
    from repro_torch.utils.trees import unflatten_rows, unflatten_vector
    host, flat = (AGGREGATORS.resolve("fedavgm:0.8") for _ in range(2))
    rng = np.random.default_rng(2)
    g = torch.tensor(rng.normal(0, 0.1, spec.total).astype(np.float32))
    v = flat.init_flat_state(g)
    params, gvec = unflatten_vector(spec, g), g
    for _ in range(2):
        rows = g + torch.tensor(rng.normal(0, 0.02, (4, spec.total)),
                                dtype=torch.float32)
        w = torch.tensor([1.0, 2.0, 3.0, 4.0])
        params = host.aggregate(params, unflatten_rows(spec, rows), w)
        gvec, v = flat.aggregate_flat(gvec, rows, w, v)
        np.testing.assert_allclose(flatten_vector(spec, params).numpy(),
                                   gvec.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


def _same_runs(a, b, exp_a, exp_b):
    assert len(a.selected) == len(b.selected)
    for x, y in zip(a.selected, b.selected):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(a.T_k, b.T_k, rtol=1e-6)
    np.testing.assert_allclose(a.E_k, b.E_k, rtol=1e-6)
    np.testing.assert_allclose(a.accuracy, b.accuracy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(exp_a.global_vec.numpy(),
                               exp_b.global_vec.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(exp_a.client_plane.numpy(),
                               exp_b.client_plane.numpy(), rtol=0, atol=1e-6)


def test_topk_host_loop_equals_the_traced_run():
    spec = ExperimentSpec(**TINY, compressor="topk:0.01",
                          aggregator="fedavgm:0.9")
    host = build_experiment(spec, device="cpu")
    traced = build_experiment(spec, device="cpu")
    h_host = host._run_host(None, TINY["rounds"], 0.0)
    h_traced = traced.run()
    assert h_traced.seconds == [] and len(h_host.seconds) == 4
    _same_runs(h_host, h_traced, host, traced)


def test_host_loop_momentum_continues_into_a_traced_run():
    """The initial round and one round on the host loop, then two rounds
    on the device-resident run (its carry's momentum: the host's), equal
    three rounds on the host loop."""
    spec = ExperimentSpec(**TINY, aggregator="fedavgm:0.9", compressor="int8")
    mixed = build_experiment(spec, device="cpu")
    h1 = mixed._run_host(None, 1, 0.0)
    v = mixed.aggregator.init_flat_state(mixed.global_vec)
    assert float(torch.max(torch.abs(v))) > 0
    assert torch.equal(mixed.traced_state().opt_state, v)
    h2 = mixed.run(rounds=2, include_initial_round=False)
    assert h2.seconds == [] and len(h2.accuracy) == 2
    host = build_experiment(spec, device="cpu")
    h = host._run_host(None, 3, 0.0)
    for k in ("selected", "T_k", "E_k", "accuracy"):
        setattr(h1, k, getattr(h1, k) + getattr(h2, k))
    _same_runs(h1, h, mixed, host)
    np.testing.assert_allclose(
        mixed.aggregator.init_flat_state(mixed.global_vec).numpy(),
        host.aggregator.init_flat_state(host.global_vec).numpy(), atol=1e-6)
