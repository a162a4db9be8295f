"""The paper's comparisons through the port's whole FL slice, against the
reference's dense host loop.

Both sides build the ``SPEC`` of ``tests/test_torch_slice.py`` (the port
on the CPU, replaying the reference's key stream through
``JaxReplayDraws``; both hosts' selection Generators seeded alike), run
the initial round, then one ``round(method)`` per (selector, allocator)
pair below in this order, the allocator swapped in as
``tests/test_api.py`` does. Selected sets must be equal; T_k and E_k agree
within each allocator's band (SAO's outer bisection 2e-3, equal bandwidth
1e-4, the FEDL grid solve 1e-2); the global row within atol 1e-4;
accuracy within one test sample.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from repro.api import ALLOCATORS as REF_ALLOCATORS
from repro.api import ExperimentSpec as RefSpec
from repro.api import build_experiment as ref_build_experiment
from repro.utils.trees import tree_flatten_vector

from repro_torch.api import ALLOCATORS, ExperimentSpec, build_experiment

from test_torch_slice import SPEC, JaxReplayDraws

PAIRS = [("kmeans_random", "sao"), ("random", "equal"), ("icas", "sao:box"),
         ("rra", "fedl:1.0"), ("stochastic-sched", "fedl_auto"),
         ("divergence", "equal")]
RTOL = {"sao": 2e-3, "equal": 1e-4, "fedl": 1e-2, "fedl_auto": 1e-2}


@pytest.fixture(scope="module")
def runs():
    ref = ref_build_experiment(RefSpec(**SPEC))
    port = build_experiment(ExperimentSpec(**SPEC), device="cpu",
                            draws=JaxReplayDraws(0))
    out = {}
    for exp, registry, side in ((ref, REF_ALLOCATORS, "ref"),
                                (port, ALLOCATORS, "port")):
        exp.initial_round()
        hist = []
        for selection, allocator in PAIRS:
            exp.allocator = registry.resolve(allocator)
            r = exp.round(selection)
            hist.append((np.asarray(r.selected), float(r.T_k),
                         float(r.E_k), float(r.accuracy)))
        out[side] = hist
    out["global"] = (np.asarray(tree_flatten_vector(ref.global_params)),
                     port.global_vec.numpy())
    return out


def test_same_selections(runs):
    for (sel_r, *_), (sel_p, *_), pair in zip(runs["ref"], runs["port"],
                                              PAIRS):
        np.testing.assert_array_equal(sel_p, sel_r, err_msg=str(pair))
        assert len(sel_p) > 0


@pytest.mark.parametrize("k", range(len(PAIRS)), ids=[
    f"{s}+{a}" for s, a in PAIRS])
def test_T_and_E_match(runs, k):
    (_, T_r, E_r, _), (_, T_p, E_p, _) = runs["ref"][k], runs["port"][k]
    rtol = RTOL[PAIRS[k][1].split(":")[0]]
    assert np.isfinite(T_p) and np.isfinite(E_p)
    np.testing.assert_allclose(T_p, T_r, rtol=rtol)
    np.testing.assert_allclose(E_p, E_r, rtol=rtol)


def test_global_row_matches(runs):
    np.testing.assert_allclose(runs["global"][1], runs["global"][0],
                               atol=1e-4)


def test_accuracy_within_one_test_sample(runs):
    for (*_, acc_r), (*_, acc_p) in zip(runs["ref"], runs["port"]):
        assert abs(acc_p - acc_r) <= 1.0 / SPEC["test_samples"] + 1e-6
