"""The population-scale partitions: ``partition_bias_lazy`` (the loop path
and the vectorized one) and ``partition_dirichlet`` of the port, equal to
the reference's arrays for the same seed (both are numpy), the lazy
indices select ``partition_bias``'s samples below the vectorized
threshold, and ``build_experiment`` switches to the lazy form for a paged
fleet at ``LAZY_PARTITION_MIN``."""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from repro.api import build as ref_build
from repro.data import partition as ref_partition
from repro.data.synthetic import make_dataset as ref_make_dataset

import repro_torch.api.build as build
from repro_torch.api import ExperimentSpec, build_experiment
from repro_torch.data import partition
from repro_torch.data.synthetic import make_dataset

FIELDS = ("pool_images", "indices", "labels", "majority", "sizes")


@pytest.fixture(scope="module")
def datasets():
    return make_dataset("fashion", 400, seed=0), ref_make_dataset(
        "fashion", 400, seed=0)


def _equal(port, ref, fields):
    for name in fields:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_thresholds_equal_the_reference():
    assert (partition.VECTORIZED_PARTITION_MIN
            == ref_partition.VECTORIZED_PARTITION_MIN)
    assert build.LAZY_PARTITION_MIN == ref_build.LAZY_PARTITION_MIN


@pytest.mark.parametrize("sigma", [0.8, "H"])
def test_lazy_loop_path_equals_the_reference(datasets, sigma):
    ds, ref_ds = datasets
    port = partition.partition_bias_lazy(ds, 30, 8, sigma, seed=5)
    ref = ref_partition.partition_bias_lazy(ref_ds, 30, 8, sigma, seed=5)
    assert port.lazy and port.num_clients == 30
    _equal(port, ref, FIELDS)
    assert port.nbytes == ref.nbytes


@pytest.mark.parametrize("sigma", [0.8, "H"])
def test_lazy_vectorized_path_equals_the_reference(datasets, sigma):
    ds, ref_ds = datasets
    n = partition.VECTORIZED_PARTITION_MIN
    port = partition.partition_bias_lazy(ds, n, 8, sigma, seed=2)
    ref = ref_partition.partition_bias_lazy(ref_ds, n, 8, sigma, seed=2)
    _equal(port, ref, FIELDS)
    # the σ-bias distribution: each client's majority class holds its
    # n_major = round(0.8·8) = 6 draws, or more when σ = "H"'s second
    # class or the rest land on it by chance (never for "H")
    hits = (port.labels == port.majority[:, None]).sum(axis=1)
    assert hits.min() >= 6
    if sigma == "H":
        assert (hits == 6).all()
        assert (np.array([len(np.unique(r)) for r in port.labels[:500]])
                <= 2).all()


def test_lazy_indices_select_the_materialized_samples(datasets):
    ds, _ = datasets
    lazy = partition.partition_bias_lazy(ds, 25, 8, 0.8, seed=3)
    fed = partition.partition_bias(ds, 25, 8, 0.8, seed=3)
    assert not fed.lazy
    np.testing.assert_array_equal(ds.images[lazy.indices], fed.images)
    for name in ("labels", "majority", "sizes"):
        np.testing.assert_array_equal(getattr(lazy, name),
                                      getattr(fed, name))


@pytest.mark.parametrize("alpha", [0.3, 5.0])
def test_dirichlet_equals_the_reference(datasets, alpha):
    ds, ref_ds = datasets
    port = partition.partition_dirichlet(ds, 12, 10, alpha, seed=4)
    ref = ref_partition.partition_dirichlet(ref_ds, 12, 10, alpha, seed=4)
    _equal(port, ref, ("images", "labels", "majority", "sizes"))


def test_paged_build_switches_to_the_lazy_partition(monkeypatch):
    tiny = dict(dataset="fashion", clients=12, samples_per_client=8,
                train_samples=200, test_samples=40, local_iters=1,
                batch_size=4, devices_per_round=3, num_clusters=3)
    monkeypatch.setattr(build, "LAZY_PARTITION_MIN", 12)
    paged = build_experiment(ExperimentSpec(**tiny, store="paged"),
                             device="cpu")
    dense = build_experiment(ExperimentSpec(**tiny), device="cpu")
    assert paged.fed.lazy and not dense.fed.lazy
    assert paged._images is None and paged._pool_images is not None
    monkeypatch.setattr(build, "LAZY_PARTITION_MIN", 13)
    assert not build_experiment(ExperimentSpec(**tiny, store="paged"),
                                device="cpu").fed.lazy
