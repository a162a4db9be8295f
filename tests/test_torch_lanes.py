"""The lane forms of the round body's functions, on the CPU: every
function a seed cohort (``core/cohort.py``) gives a leading lane axis.

(a) both kernels' plain versions, ``ops``, SAO, equal bandwidth, FEDL and
    the six ``select_traced``, on stacked inputs against a loop of
    one-lane calls: equal, or rtol 1e-6;
(b) the lane-form SAO against the reference's ``jax.vmap(solve_sao)``
    with masked padding, within SAO's band (rtol 2e-3).

The cohorts themselves: ``tests/test_torch_cohort.py``.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sao import solve_sao as ref_solve_sao
from repro.core.wireless import fleet_arrays as ref_fleet_arrays
from repro.core.wireless import sample_fleet as ref_sample_fleet

from repro_torch.api import ALLOCATORS, SELECTORS
from repro_torch.api.protocols import TracedContext
from repro_torch.core import baselines as bl
from repro_torch.core.sao import solve_sao
from repro_torch.core.wireless import fleet_arrays, sample_fleet
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flat_aggregate import flat_aggregate_plain

LANES = 3


def _normal(seed, *shape):
    return torch.tensor(np.random.default_rng(seed).normal(size=shape)
                        .astype(np.float32))


def _close(got, want):
    """Lane form against the loop of one-lane calls: rtol 1e-6."""
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


# ---------------------------------------------------------------------------
# (a) lane forms against one lane at a time
# ---------------------------------------------------------------------------


def test_flat_aggregate_lanes_match_one_lane_at_a_time():
    flat = _normal(0, LANES, 6, 1003)
    w = torch.tensor(np.abs(np.random.default_rng(1).normal(
        size=(LANES, 6))).astype(np.float32)) + 0.1
    flat[1, 2] = float("nan")                      # a NaN row at weight 0
    w[1, 2] = 0.0
    mask = torch.tensor([[True] * 6, [True, False, True, True, False, True],
                         [False] * 6])
    _close(flat_aggregate_plain(flat, w),
           torch.stack([flat_aggregate_plain(f, x) for f, x in zip(flat, w)]))
    _close(ref.flat_aggregate_ref(flat[0:1].nan_to_num(), w[0:1]),
           ref.flat_aggregate_ref(flat[0].nan_to_num(), w[0])[None])
    got = ops.flat_aggregate(flat, w, mask=mask)
    want = torch.stack([ops.flat_aggregate(f, x, mask=m)
                        for f, x, m in zip(flat, w, mask)])
    _close(got, want)
    assert torch.count_nonzero(got[2]) == 0           # an all-masked lane


def test_pairwise_lanes_match_one_lane_at_a_time():
    x = _normal(2, LANES, 7, 33)
    c = _normal(3, LANES, 3, 33)
    _close(ref.pairwise_l2_ref(x, c),
           torch.stack([ref.pairwise_l2_ref(a, b) for a, b in zip(x, c)]))
    _close(ops.pairwise_sq_dists(x, c),
           torch.stack([ops.pairwise_sq_dists(a, b) for a, b in zip(x, c)]))
    # the divergence of the first N rows of a plane with padding rows
    plane = _normal(4, LANES, 10, 257)
    gvec = _normal(5, LANES, 257)
    got = ops.client_divergence(plane[:, :7], gvec)
    assert got.shape == (LANES, 7)
    _close(got, torch.stack([ops.client_divergence(p[:7], g)
                             for p, g in zip(plane, gvec)]))


def _lane_arrays(S, padded):
    """``LANES`` fleets' arrays of S devices, stacked, and their masks
    (padding lanes carry a real device's constants, as the round gathers
    them)."""
    arr = fleet_arrays([sample_fleet(S, seed=s) for s in range(LANES)])
    assert arr["J"].shape == (LANES, S)
    mask = None
    if padded:
        mask = torch.ones((LANES, S), dtype=torch.bool)
        mask[0, -3:] = False
        mask[2, 1] = False
        for k in arr:
            arr[k][0, -3:] = arr[k][0, S - 4]
    return arr, mask


def _lane(tree, b):
    return None if tree is None else (
        {k: v[b] for k, v in tree.items()} if isinstance(tree, dict)
        else tree[b])


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("box", [False, True], ids=["sao", "box"])
def test_sao_lanes_match_one_lane_at_a_time(padded, box):
    arr, mask = _lane_arrays(9, padded)
    got = solve_sao(arr, 20.0, mask=mask, box_correct=box)
    assert got.T.shape == got.converged.shape == got.ratio.shape == (LANES,)
    for b in range(LANES):
        want = solve_sao(_lane(arr, b), 20.0, mask=_lane(mask, b),
                         box_correct=box)
        for g, w in zip(got, want):
            _close(g[b], w)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_equal_bandwidth_lanes_match_one_lane_at_a_time(padded):
    arr, mask = _lane_arrays(9, padded)
    got = bl.equal_bandwidth(arr, 20.0, mask=mask)
    T, E, _, _ = ALLOCATORS.resolve("equal").allocate_traced(arr, 20.0, mask)
    assert T.shape == E.shape == (LANES,)
    for b in range(LANES):
        want = bl.equal_bandwidth(_lane(arr, b), 20.0, mask=_lane(mask, b))
        for g, w in zip(got, want):
            _close(g[b], w)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_fedl_lanes_match_one_lane_at_a_time(padded):
    arr, mask = _lane_arrays(6, padded)
    auto = ALLOCATORS.resolve({"name": "fedl_auto",
                               "params": {"iters": 1, "n_grid": 12}})
    got = bl.fedl_lambda(arr, 20.0, 4.58, n_grid=12, mask=mask)
    # fedl_auto: a λ a lane (tune_fedl_lambda), then the solve at it
    auto_got = auto.allocate_traced(arr, 20.0, mask)
    assert auto_got[0].shape == (LANES,)
    for b in range(LANES):
        arr_b, mask_b = _lane(arr, b), _lane(mask, b)
        want = bl.fedl_lambda(arr_b, 20.0, 4.58, n_grid=12, mask=mask_b)
        for g, w in zip(got, want):
            _close(g[b], w)
        want = auto.allocate_traced(arr_b, 20.0, mask_b)
        for g, w in zip(auto_got, want):
            _close(g[b], w)


SELECTOR_NAMES = ["divergence", "kmeans_random", "random", "icas",
                  "stochastic-sched", "rra:5"]


@pytest.mark.parametrize("name", SELECTOR_NAMES)
def test_select_traced_lanes_match_one_lane_at_a_time(name):
    """Labels with a cluster smaller than s and divergences with ties, a
    lane each; the draws of the stochastic policies one a lane."""
    n = 12
    rng = np.random.default_rng(7)
    labels = torch.tensor(np.stack([rng.permutation(
        [0, 1, 0, 1, 0, 1, 2, 0, 1, 0, 1, 0]) for _ in range(LANES)]))
    div = torch.tensor(rng.gamma(2.0, 1.0, (LANES, n)).astype(np.float32))
    div[:, 3] = div[:, 5] = div[:, 1]                          # ties
    arr = fleet_arrays([sample_fleet(n, seed=s) for s in range(LANES)])
    draw = (torch.tensor(np.stack([rng.permutation(n)
                                   for _ in range(LANES)]))
            if name == "random" else
            torch.tensor(rng.random((LANES, n)).astype(np.float32)))
    sel = SELECTORS.resolve(name)
    ctx = TracedContext(n, 5, 2, 3, 20.0)
    idx, mask = sel.select_traced(draw, div, labels, arr, ctx)
    assert idx.shape == mask.shape == (LANES, sel.pad_size(ctx))
    for b in range(LANES):
        want_idx, want_mask = sel.select_traced(
            draw[b], div[b], labels[b], _lane(arr, b), ctx)
        assert torch.equal(idx[b], want_idx) and torch.equal(mask[b],
                                                             want_mask)


# ---------------------------------------------------------------------------
# (b) the lane-form SAO against the reference's vmapped solve
# ---------------------------------------------------------------------------


def test_sao_lanes_match_reference_vmap():
    """``jax.vmap(solve_sao)`` over stacked fleets with masked padding; the
    outputs compared (SAO's band, rtol 2e-3), the padding lanes at 0."""
    S = 10
    mask = np.ones((LANES, S), bool)
    mask[0, -3:] = False
    mask[1, 4] = False
    arr = fleet_arrays([sample_fleet(S, seed=s) for s in range(LANES)])
    refs = [ref_fleet_arrays(ref_sample_fleet(S, seed=s))
            for s in range(LANES)]
    stacked = {k: jnp.stack([a[k] for a in refs]) for k in refs[0]}
    want = jax.vmap(lambda a, m: ref_solve_sao(a, 20.0, mask=m))(
        stacked, jnp.asarray(mask))
    got = solve_sao(arr, 20.0, mask=torch.tensor(mask))
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), rtol=2e-3)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=2e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f), rtol=2e-3,
                               atol=1e-4)
    assert float(got.b[torch.tensor(~mask)].abs().max()) == 0.0
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
