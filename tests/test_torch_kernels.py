"""The port's kernel modules against the reference's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; those
are held against the Pallas kernels run as ``test_kernels.py`` runs them
(``interpret=True``) and against ``repro.kernels.ref``, with the same
tolerances. The wrapper guards (mask, a NaN row at weight 0, an all-masked
call) are held against ``repro.kernels.ops``. The hand-written CUDA
kernels have no CPU mode: their cases against the plain versions are in
``test_torch_cuda.py``, which imports no JAX so that it runs on the card.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.kernels.flat_aggregate import flat_aggregate as pallas_flat_agg
from repro.kernels.pairwise_l2 import pairwise_l2 as pallas_pairwise

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flat_aggregate import (flat_aggregate,
                                                flat_aggregate_plain)
from repro_torch.kernels.pairwise_l2 import pairwise_l2

AGG_TOL = dict(rtol=2e-5, atol=2e-5)      # test_kernels.py:20-22 (fp32)
L2_TOL = dict(rtol=1e-4, atol=1e-3)       # test_kernels.py:40-41 (fp32)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# plain paths against the Pallas kernels (interpret mode) and the oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,f", [(7, 3, 33), (40, 10, 224), (9, 1, 700),
                                   (1, 1, 8)])
def test_plain_pairwise_matches_pallas(n, m, f):
    x, c = _normal(n, n, f), _normal(m + 100, m, f)
    got = pairwise_l2(torch.tensor(x), torch.tensor(c)).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas_pairwise(x, c)),
                               **L2_TOL)
    np.testing.assert_allclose(got, np.asarray(jref.pairwise_l2_ref(x, c)),
                               **L2_TOL)


@pytest.mark.parametrize("n,p", [(10, 1000), (40, 513), (3, 8)])
def test_plain_flat_aggregate_matches_pallas(n, p):
    flat = _normal(p, n, p)
    w = np.abs(_normal(n + 1, n)) + 0.1
    got = flat_aggregate(torch.tensor(flat), torch.tensor(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas_flat_agg(flat, w)),
                               **AGG_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.flat_aggregate_ref(flat, w)), **AGG_TOL)
    np.testing.assert_allclose(
        ref.flat_aggregate_ref(torch.tensor(flat), torch.tensor(w)).numpy(),
        np.asarray(jref.flat_aggregate_ref(flat, w)), **AGG_TOL)


def test_ops_pairwise_sq_dists_matches_reference_cpu_path():
    x, c = _normal(1, 12, 300), _normal(2, 5, 300)
    # near-identical rows: the expansion's cancellation is clamped at 0
    c[0] = x[3] + 1e-6
    got = ops.pairwise_sq_dists(torch.tensor(x), torch.tensor(c)).numpy()
    want = np.asarray(ref_ops.pairwise_sq_dists(jnp.asarray(x),
                                                jnp.asarray(c)))
    assert got.min() >= 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_ops_client_divergence_matches_reference_cpu_path():
    flat, g = _normal(3, 9, 2000), _normal(4, 2000)
    flat[2] = g                                    # a zero divergence
    got = ops.client_divergence(torch.tensor(flat), torch.tensor(g)).numpy()
    want = np.asarray(ref_ops.client_divergence(jnp.asarray(flat),
                                                jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[2] == 0.0


def _guard_case(seed=5, n=6, p=64):
    flat = _normal(seed, n, p)
    w = np.abs(_normal(seed + 1, n)) + 0.1
    mask = np.array([True, False, True, True, False, True])[:n]
    flat[1] = np.nan                                # a NaN row, masked out
    return flat, w, mask


def test_ops_flat_aggregate_guards_match_reference():
    flat, w, mask = _guard_case()
    got = ops.flat_aggregate(torch.tensor(flat), torch.tensor(w),
                             mask=torch.tensor(mask)).numpy()
    want = np.asarray(ref_ops.flat_aggregate(jnp.asarray(flat),
                                             jnp.asarray(w),
                                             mask=jnp.asarray(mask)))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **AGG_TOL)
    # a NaN row at weight 0 (no mask) is kept out of the fold as well
    w0 = w.copy()
    w0[1] = 0.0
    got0 = ops.flat_aggregate(torch.tensor(flat), torch.tensor(w0),
                              normalize=False).numpy()
    want0 = np.asarray(ref_ops.flat_aggregate(jnp.asarray(flat),
                                              jnp.asarray(w0),
                                              normalize=False))
    assert np.all(np.isfinite(got0))
    np.testing.assert_allclose(got0, want0, **AGG_TOL)


def test_ops_flat_aggregate_all_masked_gives_zeros():
    flat, w, _ = _guard_case()
    got = ops.flat_aggregate(torch.tensor(flat), torch.tensor(w),
                             mask=torch.zeros(6, dtype=torch.bool))
    assert torch.equal(got, torch.zeros(64))


def test_plain_path_launches_nothing():
    before = (flat_aggregate.launches, pairwise_l2.launches)
    flat, w, mask = _guard_case()
    ops.flat_aggregate(torch.tensor(flat), torch.tensor(w),
                       mask=torch.tensor(mask))
    ops.pairwise_sq_dists(torch.tensor(flat[:2]), torch.tensor(flat[2:4]))
    ops.client_divergence(torch.tensor(flat[2:]), torch.tensor(flat[0]))
    assert (flat_aggregate.launches, pairwise_l2.launches) == before


def test_flat_aggregate_plain_zeroes_nonpositive_rows():
    flat, w, _ = _guard_case()
    w[1] = -1.0
    got = flat_aggregate_plain(torch.tensor(flat), torch.tensor(w)).numpy()
    keep = w > 0
    want = (flat[keep] * w[keep, None]).sum(0)
    np.testing.assert_allclose(got, want, **AGG_TOL)
