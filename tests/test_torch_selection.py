"""The port's selection stack against the reference: weight divergence,
K-means from the reference's k-means++ centroids (and the k-means++ draw
itself, replayed from the reference's key), Algorithm 4 on the
reference's divergences, and the cluster bookkeeping."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as ref_clustering
from repro.core.divergence import weight_divergence_flat as ref_divergence
from repro.core.selection import select_divergence as ref_select_divergence

from repro_torch.api.protocols import SelectionContext
from repro_torch.core.clustering import (adjusted_rand_index,
                                         clusters_from_labels,
                                         kmeans_fit, kmeans_plus_plus_init)
from repro_torch.core.divergence import weight_divergence_flat
from repro_torch.core.selection import select_divergence
from repro_torch.strategies.selectors import DivergenceSelector


def _blobs(seed, n=40, c=4, f=64, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(c, f)) * 3.0
    truth = rng.integers(0, c, n)
    x = centers[truth] + spread * rng.normal(size=(n, f))
    return x.astype(np.float32), truth


class _KeyDraws:
    """The k-means++ draws of ``repro.core.clustering.kmeans_plus_plus_init``
    from one jax key, behind the port's draws interface."""

    def __init__(self, key):
        self.key = key

    def kmeans_seed(self, n, c):
        self.keys = jax.random.split(self.key, c)
        self.n = n
        return torch.tensor(int(jax.random.randint(self.keys[0], (), 0, n)))

    def kmeans_choice(self, i, p):
        return torch.tensor(int(jax.random.choice(
            self.keys[i], self.n, p=jnp.asarray(p.numpy()))))


@pytest.mark.parametrize("seed,c", [(0, 4), (1, 6), (2, 10)])
def test_kmeans_plus_plus_replay_matches_reference(seed, c):
    x, _ = _blobs(seed, c=c)
    key = jax.random.PRNGKey(seed + 7)
    want = np.asarray(ref_clustering.kmeans_plus_plus_init(
        key, jnp.asarray(x), c))
    got = kmeans_plus_plus_init(torch.tensor(x), c, _KeyDraws(key))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,c", [(0, 4), (3, 5), (4, 10)])
def test_kmeans_fit_from_reference_centroids_gives_reference_labels(seed, c):
    x, truth = _blobs(seed, c=c, spread=1.5)
    key = jax.random.PRNGKey(seed)
    init = ref_clustering.kmeans_plus_plus_init(key, jnp.asarray(x), c)
    want_c, want_labels, want_inertia = ref_clustering.kmeans_fit(
        key, jnp.asarray(x), c)
    got_c, got_labels, got_inertia = kmeans_fit(
        torch.tensor(x), c, init_centroids=torch.tensor(np.asarray(init)))
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(want_labels))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got_inertia), float(want_inertia),
                               rtol=1e-4)
    assert adjusted_rand_index(got_labels.numpy(), truth) == \
        ref_clustering.adjusted_rand_index(np.asarray(want_labels), truth)


def test_kmeans_fit_needs_a_seeding():
    with pytest.raises(ValueError, match="draws"):
        kmeans_fit(torch.zeros((4, 3)), 2)


def _context(div, clusters, s):
    """The selection context of one round over ``div`` and ``clusters``."""
    return SelectionContext(
        rng=np.random.default_rng(0), num_devices=len(div),
        devices_per_round=10, selected_per_cluster=s, bandwidth_mhz=20.0,
        fleet=None, clusters=clusters, divergences=lambda: div)


@pytest.mark.parametrize("seed,s", [(0, 1), (1, 2), (2, 1)])
def test_select_divergence_on_reference_divergences(seed, s):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(20, 300)).astype(np.float32)
    g = rng.normal(size=300).astype(np.float32)
    div = np.array(ref_divergence(jnp.asarray(flat), jnp.asarray(g)))
    div[[3, 7]] = div[5]                               # ties
    labels = rng.integers(0, 4, 20)
    labels[[3, 5, 7]] = 1
    clusters = clusters_from_labels(torch.tensor(labels), 4)
    ref_clusters = ref_clustering.clusters_from_labels(labels, 4)
    for a, b in zip(clusters, ref_clusters):
        np.testing.assert_array_equal(a, b)
    want = ref_select_divergence(div, ref_clusters, s)
    np.testing.assert_array_equal(select_divergence(div, clusters, s), want)
    np.testing.assert_array_equal(
        DivergenceSelector().select(_context(div, clusters, s)), want)


def test_selector_needs_clusters():
    with pytest.raises(ValueError, match="clusters"):
        DivergenceSelector().select(_context(np.zeros(3), None, 1))


def test_weight_divergence_matches_reference():
    rng = np.random.default_rng(8)
    flat = rng.normal(size=(12, 5000)).astype(np.float32)
    g = flat[4] + 1e-4 * rng.normal(size=5000).astype(np.float32)
    got = weight_divergence_flat(torch.tensor(flat), torch.tensor(g)).numpy()
    want = np.asarray(ref_divergence(jnp.asarray(flat), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_adjusted_rand_index_matches_reference():
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, 5, 50), rng.integers(0, 4, 50)
    assert adjusted_rand_index(a, b) == ref_clustering.adjusted_rand_index(
        a, b)
    assert adjusted_rand_index(a, a) == 1.0


def _stacked_tree(seed, n=5):
    """A client-stacked tree, nested (the reference's) and flat (the
    port's ``/``-joined names)."""
    rng = np.random.default_rng(seed)
    tree = {"w_c1": rng.normal(size=(n, 3, 3, 2)),
            "blocks": {"attn": {"wq_b": rng.normal(size=(n, 2, 4))}},
            "w_fc2": rng.normal(size=(n, 6, 3)),
            "b_fc2": rng.normal(size=(n, 3))}
    tree = jax.tree_util.tree_map(lambda x: x.astype(np.float32), tree)
    flat = {"w_c1": tree["w_c1"], "blocks/attn/wq_b":
            tree["blocks"]["attn"]["wq_b"], "w_fc2": tree["w_fc2"],
            "b_fc2": tree["b_fc2"]}
    return tree, {k: torch.as_tensor(v) for k, v in flat.items()}


@pytest.mark.parametrize("layer", ["auto", "all", "wq_b", "b_fc2"])
def test_extract_features_matches_the_reference(layer):
    tree, flat = _stacked_tree(0)
    want = ref_clustering.extract_features(
        jax.tree_util.tree_map(jnp.asarray, tree), layer)
    from repro_torch.core.clustering import extract_features
    np.testing.assert_array_equal(extract_features(flat, layer).numpy(),
                                  np.asarray(want))


def test_stacked_divergence_and_distance_matrix_match_the_reference():
    from repro.core.divergence import (pairwise_divergence_matrix as ref_pdm,
                                       weight_divergence as ref_wd)
    from repro_torch.core.divergence import (pairwise_divergence_matrix,
                                             weight_divergence)
    tree, flat = _stacked_tree(1)
    glob = {k: v[0] * 0.5 for k, v in flat.items()}
    want = ref_wd(jax.tree_util.tree_map(jnp.asarray, tree),
                  jax.tree_util.tree_map(lambda v: jnp.asarray(v[0] * 0.5),
                                         tree))
    np.testing.assert_allclose(weight_divergence(flat, glob).numpy(),
                               np.asarray(want), rtol=1e-6)
    # squared, at the pairwise kernel's tolerance: the diagonal is the
    # square root of each side's cancellation residual (≈ 6e-5 -> 0.008)
    x, _ = _blobs(2, n=12, f=16)
    np.testing.assert_allclose(
        pairwise_divergence_matrix(torch.as_tensor(x)).numpy() ** 2,
        np.asarray(ref_pdm(jnp.asarray(x))) ** 2, rtol=1e-4, atol=1e-3)
