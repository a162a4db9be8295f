"""The streaming reductions over the paged store (``kernels/chunked.py``)
and the minibatch K-means (``core/clustering.py``) against the
reference's, and inside the port: a chunked divergence is the bits of one
call, at any chunk (the paged ≡ dense pins rest on it); the divergence's
slab plan on the card is a function of P alone.

Tolerances: divergence rtol 1e-6, pairwise rtol 1e-4 / atol 1e-3 (the
kernel's), streaming mean 1e-6 (two libraries' fp32 sums); K-means on the
reference's k-means++ draws: labels equal, centroids rtol 1e-5."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as ref_clustering
from repro.kernels import chunked as ref_chunked

from repro_torch.core.clustering import (_chunk_assign_stats, kmeans_fit,
                                         kmeans_fit_minibatch)
from repro_torch.core.store import PagedStore
from repro_torch.kernels import chunked, ops
from repro_torch.kernels.pairwise_l2 import (CENTROID_SLAB, CENTROID_SLABS,
                                             DIVERGENCE_SLAB, GROUP_ROWS,
                                             KERNELS, MAX_CENTROIDS, MAX_ROWS,
                                             MAX_SUMS, TARGET_BLOCKS,
                                             plan_centroids, plan_divergence,
                                             plan_pairwise, plan_rows,
                                             plan_slabs)

P_MNIST = 113_744
F_QWEN2_EMBED = 151_936 * 1536          # the LM cell's tied embed
N = 23


@pytest.fixture(scope="module")
def plane():
    rng = np.random.default_rng(0)
    g = rng.standard_normal(P_MNIST).astype(np.float32)
    rows = (g + 0.05 * rng.standard_normal((N, P_MNIST))).astype(np.float32)
    return rows, g


class KeyDraws:
    """The reference's k-means++ draws from one key (``kmeans_plus_plus_init``
    splits it into ``c`` keys) behind the port's draws interface."""

    def __init__(self, key):
        self.key = key

    def kmeans_seed(self, n, c):
        self.keys, self.n = jax.random.split(self.key, c), n
        return torch.tensor(int(jax.random.randint(self.keys[0], (), 0, n)))

    def kmeans_choice(self, i, p):
        return torch.tensor(int(jax.random.choice(
            self.keys[i], self.n, p=jnp.asarray(p.numpy()))))


def test_default_chunk_size_equals_the_reference():
    for p in (1, 2240, 19_522, P_MNIST, 563_200, 10 ** 8):
        assert chunked.default_chunk_size(p) == ref_chunked.default_chunk_size(p)
    assert chunked.DEFAULT_CHUNK_BYTES == ref_chunked.DEFAULT_CHUNK_BYTES
    assert chunked.default_chunk_size(P_MNIST) == 147


@pytest.mark.parametrize("chunk", [1, 5, N])
def test_chunked_divergence_against_the_reference(plane, chunk):
    rows, g = plane
    want = np.asarray(ref_chunked.chunked_client_divergence(
        rows, jnp.asarray(g), chunk_size=chunk))
    got = chunked.chunked_client_divergence(rows, torch.tensor(g),
                                            chunk_size=chunk)
    assert got.dtype == np.float32 and got.shape == (N,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    blocks = iter([rows[s:s + chunk] for s in range(0, N, chunk)])
    np.testing.assert_array_equal(
        ops.chunked_client_divergence(blocks, torch.tensor(g)), got)


def test_chunked_divergence_is_the_bits_of_one_call(plane):
    rows, g = plane
    one = ops.client_divergence(torch.tensor(rows), torch.tensor(g)).numpy()
    for chunk in (1, 2, 4, 7, N):
        np.testing.assert_array_equal(chunked.chunked_client_divergence(
            torch.tensor(rows), torch.tensor(g), chunk_size=chunk), one)
    store = PagedStore(g, N, chunk_size=6)
    store.scatter(np.arange(0, N, 2), rows[::2])
    assembled = np.concatenate(list(store.iter_chunks()))
    one = ops.client_divergence(torch.tensor(assembled),
                                torch.tensor(g)).numpy()
    np.testing.assert_array_equal(chunked.chunked_client_divergence(
        store.iter_chunks(3), torch.tensor(g)), one)


def test_chunked_pairwise_against_the_reference():
    """At the shape the paged path streams it: minibatch K-means on the
    paper CNN's ``w_fc2`` features (F = 2240, c = 10). Both CPU paths
    spell it ‖x‖² + ‖c‖² − 2x·c, so a row's distance to itself (or to a
    near copy) cancels to the products' rounding, which differs between
    the two libraries; the K-means centroids here are other points."""
    rng = np.random.default_rng(2)
    rows = (0.05 * rng.standard_normal((N, 2240))).astype(np.float32)
    cents = (0.05 * rng.standard_normal((10, 2240))).astype(np.float32)
    want = np.asarray(ref_chunked.chunked_pairwise(
        rows, jnp.asarray(cents), chunk_size=5))
    got = ops.chunked_pairwise(rows, torch.tensor(cents), chunk_size=5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    # one chunk is one ops.pairwise_sq_dists call
    one = ops.pairwise_sq_dists(torch.tensor(rows), torch.tensor(cents))
    np.testing.assert_array_equal(
        chunked.chunked_pairwise(rows, torch.tensor(cents), chunk_size=N),
        one.numpy())


def test_empty_streams_give_empty_results(plane):
    _, g = plane
    assert chunked.chunked_client_divergence(iter([]), g).shape == (0,)
    assert chunked.chunked_pairwise(iter([]), np.zeros((3, 4),
                                                       np.float32)).shape \
        == (0, 3)


def test_streaming_weighted_mean_against_the_reference(plane):
    rows, _ = plane
    w = np.random.default_rng(1).uniform(1.0, 5.0, N)
    cuts = (0, 4, 11, N)
    blocks = [(rows[a:b], w[a:b]) for a, b in zip(cuts, cuts[1:])]
    want = np.asarray(ref_chunked.streaming_weighted_mean(blocks, P_MNIST))
    got = chunked.streaming_weighted_mean(
        [(torch.tensor(r), x) for r, x in blocks], P_MNIST)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    one = ops.flat_aggregate(torch.tensor(rows),
                             torch.tensor(w, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(7)
    centers = 4.0 * rng.standard_normal((3, 16))
    x = np.concatenate([c + rng.standard_normal((20, 16)) for c in centers])
    return x[rng.permutation(60)].astype(np.float32)


def _stream(x, chunk):
    return lambda: (x[s:s + chunk] for s in range(0, x.shape[0], chunk))


def test_minibatch_kmeans_against_the_reference(blobs):
    key = jax.random.PRNGKey(3)
    c_r, l_r, i_r = ref_clustering.kmeans_fit_minibatch(
        key, _stream(blobs, 25), 3, iters=10)
    c_p, l_p, i_p = kmeans_fit_minibatch(_stream(blobs, 25), 3, iters=10,
                                         draws=KeyDraws(key))
    np.testing.assert_array_equal(l_p.numpy(), np.asarray(l_r))
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_r), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(i_p, float(i_r), rtol=1e-5)
    assert l_p.shape == (60,) and len(np.unique(l_p.numpy())) == 3


def test_single_chunk_minibatch_is_kmeans_fit(blobs):
    key = jax.random.PRNGKey(5)
    c_m, l_m, i_m = kmeans_fit_minibatch(_stream(blobs, 60), 3, iters=8,
                                         draws=KeyDraws(key))
    c_f, l_f, i_f = kmeans_fit(torch.tensor(blobs), 3, 8,
                               draws=KeyDraws(key))
    torch.testing.assert_close(c_m, c_f, rtol=0, atol=0)
    torch.testing.assert_close(l_m, l_f, rtol=0, atol=0)
    assert float(i_m) == float(i_f)
    with pytest.raises(ValueError, match="empty feature stream"):
        kmeans_fit_minibatch(lambda: iter([]), 3, draws=KeyDraws(key))


def test_chunk_assign_stats_against_the_reference(blobs):
    cents = blobs[[0, 7, 30]]
    s_r, n_r, i_r = ref_clustering._chunk_assign_stats(
        jnp.asarray(blobs), jnp.asarray(cents), 3)
    s_p, n_p, i_p = _chunk_assign_stats(torch.tensor(blobs),
                                        torch.tensor(cents), 3)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_r))
    np.testing.assert_allclose(float(i_p), float(i_r), rtol=1e-5)


@pytest.mark.parametrize("f", [2240, P_MNIST, 563_200])
def test_divergence_plan_depends_on_f_alone(f):
    """The card's one-centroid plan: the same ``(slabs, width)`` at every
    row count (``plan_slabs`` of n varies: 14 slabs at n = 40, 4 at 147,
    1 at 528 for the paper CNN, so a chunked refresh summed other slab
    partials than the dense call), each column in one slab, and the main
    path's plan (``plan_slabs(40, 1, 113744)``) kept."""
    slabs, width = plan_divergence(f)
    assert width % 4 == 0 and width <= DIVERGENCE_SLAB
    assert (slabs - 1) * width < f <= slabs * width
    assert {plan_slabs(n, 1, f) for n in (1, 10, 40, 147, 528, 1000)} != {
        (slabs, width)} or f <= DIVERGENCE_SLAB
    assert slabs == {2240: 1, P_MNIST: 14, 563_200: 70}[f]
    assert plan_divergence(P_MNIST) == plan_slabs(40, 1, P_MNIST)
    assert plan_divergence(616_704)[0] == 76


@pytest.mark.parametrize("lanes,n,m,f,rows", [
    (1, 40, 10, 2240, 1),               # K-means: a block a (pair, slab)
    (1, 40, 1, P_MNIST, 1),             # the paper CNN's divergence
    (8, 40, 1, P_MNIST, 1),             # a cohort of 8 seeds
    (1, 16, 1, 2048 * 32_000, 16),      # the LM round's lm_head leaf
    (1, 16, 1, 22 * 2048 * 5632, 16),   # its largest stacked leaf
    (1, 1000, 1, 16_777_216, MAX_ROWS),  # more rows than a block walks
    (1, 16, 1, 2048 * 2048, 1),         # 517 slabs: under the target
])
def test_rows_a_block_walk_only_where_the_slabs_fill_the_card(
        lanes, n, m, f, rows):
    """``plan_rows``: a block walks every row of its slab (at most
    ``MAX_ROWS``) where the (lane, centroid, slab) blocks alone reach
    ``TARGET_BLOCKS``, so each slab of c is read once; else one row a
    block, as many blocks as (pair, slab) partials. The groups cover the
    rows exactly once."""
    slabs = (plan_divergence(f) if m == 1 else plan_slabs(n, m, f))[0]
    got = plan_rows(lanes, n, m, slabs)
    assert got == rows
    assert (got > 1) == (lanes * m * slabs >= TARGET_BLOCKS)
    groups = -(-n // got)
    assert 1 <= got <= MAX_ROWS and (groups - 1) * got < n <= groups * got


PAIRS, WALK, CENTROID_WALK = KERNELS


@pytest.mark.parametrize("lanes,n,m,f,kernel", [
    (1, 16, 4, F_QWEN2_EMBED, CENTROID_WALK),   # the LM round's K-means
    (1, 16, 2, F_QWEN2_EMBED, CENTROID_WALK),
    (1, 16, MAX_CENTROIDS, F_QWEN2_EMBED, CENTROID_WALK),
    (2, 16, 4, F_QWEN2_EMBED, CENTROID_WALK),   # lanes keep the plan
    (1, 16, 4, TARGET_BLOCKS * CENTROID_SLAB, CENTROID_WALK),  # the least F
    (1, 16, 4, TARGET_BLOCKS * CENTROID_SLAB - 1, PAIRS),
    (1, 16, MAX_CENTROIDS + 1, F_QWEN2_EMBED, PAIRS),
    (1, 40, 10, 2240, PAIRS),           # the paper CNN's K-means
    (8, 40, 10, 2240, PAIRS),           # a cohort of 8 seeds
    (1, 147, 10, 2240, PAIRS),          # a minibatch K-means chunk
    (1, 10, 4, 22_528, PAIRS),          # tinyllama's K-means
    (1, 147, 10, P_MNIST, PAIRS),       # the paged store's chunks over P
    (1, 128, 10, P_MNIST, PAIRS),
    (1, 31, 10, P_MNIST, PAIRS),
    (1, 16, 4, 4096, PAIRS),            # feature_slice 4096
    (1, 16, 1, F_QWEN2_EMBED, PAIRS),   # one centroid: never the walk
    (16, 16, 1, 2048 * 32_000, WALK),   # 16 lanes of one centroid
    (8, 40, 1, P_MNIST, PAIRS),
])
def test_the_centroid_walk_engages_on_wide_k_means_alone(
        lanes, n, m, f, kernel):
    """``plan_pairwise`` picks the centroid walk from the shapes alone: 2
    to ``MAX_CENTROIDS`` centroids over an F of at least ``TARGET_BLOCKS``
    slabs of ``CENTROID_SLAB`` columns (the LM round's K-means over its
    whole tied embedding). Every other call keeps its kernel and its
    plan."""
    got = plan_pairwise(lanes, n, m, f)
    assert got[0] == kernel
    walk = plan_centroids(n, m, f)
    assert (walk is not None) == (kernel == CENTROID_WALK)
    if walk is None:
        slabs, width = plan_slabs(n, m, f)
        assert got == (kernel, slabs, width, plan_rows(lanes, n, m, slabs))
    else:
        assert got == (kernel, *walk)


@pytest.mark.parametrize("f", [TARGET_BLOCKS * CENTROID_SLAB,
                               TARGET_BLOCKS * CENTROID_SLAB + 1,
                               4_194_307,                  # ragged
                               8_388_608, F_QWEN2_EMBED, 2 ** 31 - 1])
def test_the_centroid_walk_covers_each_column_once(f):
    """Its slabs cover F once each, whole vectors of at least
    ``CENTROID_SLAB`` columns, between ``TARGET_BLOCKS`` and
    ``CENTROID_SLABS`` of them (the second pass stays a few thousand
    partials a pair)."""
    slabs, width, _ = plan_centroids(16, 4, f)
    assert width % 4 == 0 and width >= CENTROID_SLAB
    cover = np.zeros(f + width, dtype=np.int8) if f < 10 ** 8 else None
    if cover is not None:
        for s in range(slabs):
            cover[s * width:min(f, (s + 1) * width)] += 1
        assert (cover[:f] == 1).all()
    assert (slabs - 1) * width < f <= slabs * width
    assert TARGET_BLOCKS <= slabs <= CENTROID_SLABS


@pytest.mark.parametrize("m", range(2, MAX_CENTROIDS + 1))
@pytest.mark.parametrize("n", [1, 5, 16, 23, 64])
def test_the_centroid_walk_keeps_its_sums_in_registers(n, m):
    """A block takes ``rows`` rows against every centroid: rows × m, and
    rows × the centroid slots the kernel compiles (m up to 4, 8 or 16),
    stay within ``MAX_SUMS`` registers; at most ``GROUP_ROWS`` rows, and
    the groups cover the rows once."""
    rows = plan_centroids(n, m, F_QWEN2_EMBED)[2]
    slots = 4 if m <= 4 else 8 if m <= 8 else 16
    assert 1 <= rows <= min(n, GROUP_ROWS)
    assert rows * m <= rows * slots <= MAX_SUMS
    assert rows == min(n, GROUP_ROWS, MAX_SUMS // slots)
    groups = -(-n // rows)
    assert (groups - 1) * rows < n <= groups * rows


@pytest.mark.parametrize("n,m,f", [(16, 4, F_QWEN2_EMBED),
                                   (7, 3, 4_194_307),
                                   (5, 16, 8_388_608),
                                   (40, 10, 2240), (10, 4, 22_528)])
def test_the_kernel_plan_is_a_function_of_the_shapes(n, m, f):
    """The same kernel and slab plan at every call and at any number of
    lanes (a lane of a cohort's call sums as its one-lane call does); the
    centroid walk's rows too, and its slabs at any number of rows."""
    one = plan_pairwise(1, n, m, f)
    for lanes in (1, 2, 8, 1):
        got = plan_pairwise(lanes, n, m, f)
        assert got[1:3] == one[1:3]
        if one[0] == CENTROID_WALK:
            assert got == one
    if one[0] == CENTROID_WALK:
        assert {plan_centroids(k, m, f)[:2] for k in (1, 2, n, 64)} == {
            one[1:3]}
