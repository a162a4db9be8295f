"""The host API the reference's figure scripts call, on the port:
``FLHistory.total_T``/``total_E`` and ``FLExperiment.train_clients``,
``aggregate`` and ``store_clients``, each against the reference on the
CPU from the reference's key stream (models and rows within atol 1e-4,
totals within SAO's band, rtol 2e-3)."""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from repro.api import ExperimentSpec as RefSpec
from repro.api import build_experiment as ref_build_experiment
from repro.utils.trees import flatten_stacked, tree_flatten_vector

from repro_torch.api import ExperimentSpec, build_experiment
from repro_torch.utils.trees import flatten_stacked as port_flatten_stacked

from test_torch_slice import SPEC, JaxReplayDraws


@pytest.mark.parametrize("aggregator", ["fedavg", "fedavgm:0.9",
                                        "trimmed:0.2"])
def test_train_aggregate_store_match_the_reference(aggregator):
    kw = dict(SPEC, aggregator=aggregator)
    ref = ref_build_experiment(RefSpec(**kw))
    port = build_experiment(ExperimentSpec(**kw), device="cpu",
                            draws=JaxReplayDraws(0))
    idx = np.asarray([1, 4, 6])
    for _ in range(2):                 # twice: FedAvgM's momentum carries
        st_r = ref.train_clients(idx)
        st_p = port.train_clients(idx)
        assert set(st_p) == set(st_r)
        for k in st_p:
            assert tuple(st_p[k].shape) == tuple(np.shape(st_r[k]))
        rows_p = port_flatten_stacked(port.flat_spec, st_p)
        np.testing.assert_allclose(rows_p.numpy(),
                                   np.asarray(flatten_stacked(st_r)),
                                   atol=1e-4)
        ref.aggregate(st_r, idx)
        port.aggregate(st_p, idx)
        ref.store_clients(st_r, idx)
        port.store_clients(rows_p, idx)
        np.testing.assert_allclose(
            port.global_vec.numpy(),
            np.asarray(tree_flatten_vector(ref.global_params)), atol=1e-4)
    np.testing.assert_allclose(port.client_plane.numpy(),
                               np.asarray(ref.client_params), atol=1e-4)


def test_history_totals_match_the_reference():
    ref = ref_build_experiment(RefSpec(**SPEC))
    port = build_experiment(ExperimentSpec(**SPEC), device="cpu",
                            draws=JaxReplayDraws(0))
    h_r = ref.run(target_accuracy=2.0)
    h_p = port.run(target_accuracy=2.0)
    assert h_p.total_T == pytest.approx(float(np.sum(h_p.T_k)))
    assert h_p.total_E == pytest.approx(float(np.sum(h_p.E_k)))
    np.testing.assert_allclose(h_p.total_T, h_r.total_T, rtol=2e-3)
    np.testing.assert_allclose(h_p.total_E, h_r.total_E, rtol=2e-3)
    assert isinstance(h_p.total_T, float) and isinstance(h_p.total_E, float)
