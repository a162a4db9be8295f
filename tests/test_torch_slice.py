"""The port's whole FL slice against the reference's dense host loop.

Both sides build the same small spec; the reference runs its
``initial_round()`` and two ``round()``s, the port the same on the CPU
with a draws object that replays the reference's ``jax.random`` key
stream (initial parameters, each round's batch indices, the k-means++
choices). Selected sets must be equal; T_k and E_k agree within the SAO
outer bisection's band (rtol 2e-3); the global row within fp32
summation-order drift (atol 1e-4); accuracy within one test sample.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as RefSpec
from repro.api import build_experiment as ref_build_experiment
from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core.faults import FaultSpec as RefFaultSpec
from repro.core.faults import byzantine_clients as ref_byzantine_clients
from repro.core.faults import draw_fault_masks as ref_draw_fault_masks
from repro.models.cnn import init_cnn as ref_init_cnn
from repro.utils.trees import tree_flatten_vector

from repro_torch.api import ExperimentSpec, build_experiment
from repro_torch.utils.trees import params_from_jax

SPEC = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            devices_per_round=4, num_clusters=4, rounds=2)


class JaxReplayDraws:
    """The reference experiment's key stream behind the port's draws
    interface: one ``split`` of the experiment key per use, in the
    reference's order (init, initial-round training, K-means, one per
    round)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def _next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def init_params(self, model_cfg):
        ref_cfg = RefCNNConfig(**dataclasses.asdict(model_cfg))
        params = ref_init_cnn(ref_cfg, self._next())
        return params_from_jax({k: np.asarray(v) for k, v in params.items()})

    def batch_indices(self, n, local_iters, batch_size, num_samples):
        keys = jax.random.split(self._next(), n)
        idx = [[np.asarray(jax.random.randint(k, (batch_size,), 0,
                                              num_samples))
                for k in jax.random.split(key, local_iters)] for key in keys]
        return torch.tensor(np.asarray(idx), dtype=torch.long)

    def churn_step(self, n):
        """One tick's churn: the reference's ``churn_step`` splits one key
        off the stream, then that key into the leave and join keys."""
        k_leave, k_join = jax.random.split(self._next())
        return tuple(torch.tensor(np.asarray(jax.random.uniform(k, (n,))))
                     for k in (k_leave, k_join))

    def channel_init(self, shape):
        """The fade's h_0: the reference's ``_gm_init`` draw."""
        return self._complex_normal(shape)

    def channel_step(self, shape):
        """One round's fade innovation: ``_gm_step``'s draw."""
        return self._complex_normal(shape)

    def _complex_normal(self, shape):
        w = jax.random.normal(self._next(), tuple(shape) + (2,),
                              jnp.float32) * float(np.sqrt(0.5))
        return torch.tensor(np.asarray(w))

    def kmeans_seed(self, n, c):
        self.km_keys = jax.random.split(self._next(), c)
        self.km_n = n
        return torch.tensor(int(jax.random.randint(self.km_keys[0], (), 0,
                                                    n)))

    def kmeans_choice(self, i, p):
        return torch.tensor(int(jax.random.choice(
            self.km_keys[i], self.km_n, p=jnp.asarray(p.numpy()))))



class FaultReplayDraws(JaxReplayDraws):
    """The reference's key stream, its fault draws included: one split
    per round's (or tick's) masks (``draw_fault_masks``), and the
    byzantine subset from ``PRNGKey(spec.seed)``."""

    def fault_masks(self, spec, shape):
        drop, corrupt = ref_draw_fault_masks(
            self._next(), RefFaultSpec(**spec.to_dict()), shape)
        return torch.tensor(np.stack([np.asarray(drop),
                                      np.asarray(corrupt)]))

    def byzantine(self, spec, n):
        return torch.tensor(ref_byzantine_clients(
            RefFaultSpec(**spec.to_dict()), n))

@pytest.fixture(scope="module")
def runs():
    ref = ref_build_experiment(RefSpec(**SPEC))
    port = build_experiment(ExperimentSpec(**SPEC), device="cpu",
                            draws=JaxReplayDraws(0))
    init_ref = tree_flatten_vector(ref.global_params)
    out = {"init": (np.asarray(init_ref), port.global_vec.numpy().copy())}
    for exp, side in ((ref, "ref"), (port, "port")):
        exp.initial_round()
        acc0, _ = exp.evaluate()
        T0, E0 = exp.allocate(np.arange(SPEC["clients"]))
        hist = [(np.arange(SPEC["clients"]), float(T0), float(E0), acc0)]
        for _ in range(2):
            r = exp.round()
            hist.append((np.asarray(r.selected), float(r.T_k), float(r.E_k),
                         float(r.accuracy)))
        out[side] = hist
    out["labels"] = (np.asarray(ref.cluster_labels), port.cluster_labels)
    out["global"] = (np.asarray(tree_flatten_vector(ref.global_params)),
                     port.global_vec.numpy())
    out["plane"] = (np.asarray(ref.client_params), port.client_plane.numpy())
    return out


def test_same_initial_weights_and_clusters(runs):
    ref0, port0 = runs["init"]
    assert np.array_equal(ref0, port0)
    np.testing.assert_array_equal(*runs["labels"])


def test_same_selections(runs):
    for (sel_r, *_), (sel_p, *_) in zip(runs["ref"], runs["port"]):
        np.testing.assert_array_equal(sel_p, sel_r)


def test_T_and_E_match(runs):
    for (_, T_r, E_r, _), (_, T_p, E_p, _) in zip(runs["ref"], runs["port"]):
        np.testing.assert_allclose(T_p, T_r, rtol=2e-3)
        np.testing.assert_allclose(E_p, E_r, rtol=2e-3)


def test_global_row_and_plane_match(runs):
    np.testing.assert_allclose(runs["global"][1], runs["global"][0],
                               atol=1e-4)
    np.testing.assert_allclose(runs["plane"][1], runs["plane"][0], atol=1e-4)


def test_accuracy_within_one_test_sample(runs):
    for (*_, acc_r), (*_, acc_p) in zip(runs["ref"], runs["port"]):
        assert abs(acc_p - acc_r) <= 1.0 / SPEC["test_samples"] + 1e-6


def test_port_run_records_the_host_loop():
    """``run()`` is the initial round plus ``rounds`` rounds, with every
    round's band use inside B."""
    exp = build_experiment(ExperimentSpec(**SPEC), device="cpu")
    hist = exp.run()
    assert len(hist.accuracy) == SPEC["rounds"] + 1
    assert all(np.isfinite(hist.T_k)) and all(np.isfinite(hist.E_k))
    assert all(b <= 20.0 * (1 + 1e-4) for b in hist.band_mhz)
    assert [len(s) for s in hist.selected] == [8, 4, 4]
