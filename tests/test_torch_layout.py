"""The port's flat parameter plane against the reference: a port row is the
same vector as a reference row (leaf order, offsets, sizes, layouts)."""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNN_CONFIGS as REF_CNN_CONFIGS
from repro.core.clustering import resolve_feature_columns as ref_resolve
from repro.core.engine import model_flat_spec as ref_model_flat_spec
from repro.models.cnn import init_cnn as ref_init_cnn
from repro.utils import trees as ref_trees

from repro_torch.configs.paper_cnn import CNN_CONFIGS
from repro_torch.core.clustering import resolve_feature_columns
from repro_torch.core.engine import model_flat_spec
from repro_torch.utils.trees import (flatten_stacked, flatten_vector,
                                     params_from_jax, params_to_jax,
                                     unflatten_rows, unflatten_vector)


@pytest.mark.parametrize("dataset", ["mnist", "fashion", "cifar10", "micro"])
def test_flat_spec_matches_reference(dataset):
    assert (dataclasses.asdict(CNN_CONFIGS[dataset])
            == dataclasses.asdict(REF_CNN_CONFIGS[dataset]))
    got = model_flat_spec(CNN_CONFIGS[dataset])
    want = ref_model_flat_spec(REF_CNN_CONFIGS[dataset])
    assert got.names == want.names
    assert got.shapes == want.shapes
    assert got.offsets == want.offsets
    assert got.sizes == want.sizes
    assert got.total == want.total
    assert got.dtypes == tuple(str(np.dtype(d)) for d in want.dtypes)


def test_mnist_offsets_pinned():
    spec = model_flat_spec(CNN_CONFIGS["mnist"])
    assert spec.names == ("b_c1", "b_c2", "b_fc1", "b_fc2",
                          "w_c1", "w_c2", "w_fc1", "w_fc2")
    assert spec.offsets == (0, 15, 43, 267, 277, 652, 11152, 111504)
    assert spec.total == 113_744
    assert model_flat_spec(CNN_CONFIGS["fashion"]).total == 19_522


def _ref_params(dataset, seed):
    return ref_init_cnn(REF_CNN_CONFIGS[dataset], jax.random.PRNGKey(seed))


@pytest.mark.parametrize("dataset", ["mnist", "fashion"])
def test_params_from_jax_row_is_the_reference_row(dataset):
    ref = _ref_params(dataset, 3)
    spec = model_flat_spec(CNN_CONFIGS[dataset])
    row = flatten_vector(spec, params_from_jax(
        {k: np.asarray(v) for k, v in ref.items()}))
    assert np.array_equal(row.numpy(),
                          np.asarray(ref_trees.tree_flatten_vector(ref)))


def test_params_round_trip():
    ref = {k: np.asarray(v) for k, v in _ref_params("fashion", 1).items()}
    back = params_to_jax(params_from_jax(ref))
    assert set(back) == set(ref)
    for k in ref:
        assert back[k].dtype == ref[k].dtype
        assert np.array_equal(back[k], ref[k])


def test_flatten_stacked_matches_reference_and_round_trips():
    spec = model_flat_spec(CNN_CONFIGS["fashion"])
    rng = np.random.default_rng(0)
    stacked = {n: rng.normal(size=(3,) + s).astype(np.float32)
               for n, s in zip(spec.names, spec.shapes)}
    rows = flatten_stacked(spec, {k: torch.tensor(v)
                                  for k, v in stacked.items()})
    want = ref_trees.flatten_stacked({k: jax.numpy.asarray(v)
                                      for k, v in stacked.items()})
    assert rows.shape == (3, spec.total)
    assert np.array_equal(rows.numpy(), np.asarray(want))
    back = unflatten_rows(spec, rows)
    for k, v in stacked.items():
        assert np.array_equal(back[k].numpy(), v)
    one = unflatten_vector(spec, rows[1])
    assert np.array_equal(flatten_vector(spec, one).numpy(), rows[1].numpy())
    # a feature slice is the leaf's own values, row-major
    assert np.array_equal(rows[:, spec.columns("w_fc2")].numpy(),
                          stacked["w_fc2"].reshape(3, -1))


@pytest.mark.parametrize("layer", ["auto", "all", "w_c1", "b_fc2", "nope"])
def test_feature_columns_match_reference(layer):
    spec = model_flat_spec(CNN_CONFIGS["mnist"])
    ref_spec = ref_model_flat_spec(REF_CNN_CONFIGS["mnist"])
    if layer == "nope":
        with pytest.raises(KeyError):
            resolve_feature_columns(spec, layer)
        return
    assert resolve_feature_columns(spec, layer) == ref_resolve(ref_spec,
                                                               layer)
