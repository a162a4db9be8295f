"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every case is marked ``cuda`` and skips where there
is no card; the file imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flat_aggregate import (flat_aggregate,
                                                flat_aggregate_plain)
from repro_torch.kernels.pairwise_l2 import pairwise_l2

AGG_TOL = dict(rtol=2e-5, atol=2e-5)      # the reference's fp32 kernel tests
L2_TOL = dict(rtol=1e-4, atol=1e-3)

pytestmark = pytest.mark.cuda


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,p", [(10, 113_744), (40, 113_744), (7, 1001),
                                 (1, 4)])
def test_flat_aggregate_matches_plain(cuda, n, p):
    flat = torch.tensor(_normal(n, n, p), device=cuda)
    w = torch.tensor(np.abs(_normal(n + 1, n)) + 0.1, device=cuda)
    if n > 1:
        flat[n // 2] = float("nan")                # a NaN row at weight 0
        w[n // 2] = 0.0
    before = flat_aggregate.launches
    got = flat_aggregate(flat, w)
    torch.cuda.synchronize()
    assert flat_aggregate.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, flat_aggregate_plain(flat, w), **AGG_TOL)


@pytest.mark.parametrize("n,m,f", [(40, 10, 2240), (40, 1, 113_744),
                                   (7, 3, 33), (1, 1, 8)])
def test_pairwise_l2_matches_plain(cuda, n, m, f):
    x = torch.tensor(_normal(n, n, f), device=cuda)
    c = torch.tensor(_normal(m + 100, m, f), device=cuda)
    before = pairwise_l2.launches
    got = pairwise_l2(x, c)
    torch.cuda.synchronize()
    assert pairwise_l2.launches == before + 1
    torch.testing.assert_close(got, ref.pairwise_l2_ref(x, c), **L2_TOL)


def test_ops_on_cuda_launch_the_kernels(cuda):
    flat = torch.tensor(_normal(1, 6, 4096), device=cuda)
    w = torch.tensor(np.abs(_normal(2, 6)) + 0.1, device=cuda)
    mask = torch.tensor([True, False, True, True, False, True], device=cuda)
    flat[1] = float("nan")
    before = (flat_aggregate.launches, pairwise_l2.launches)
    g = ops.flat_aggregate(flat, w, mask=mask)
    d = ops.client_divergence(flat[2:], g)
    ops.pairwise_sq_dists(flat[2:], flat[2:4])
    torch.cuda.synchronize()
    assert (flat_aggregate.launches, pairwise_l2.launches) == (
        before[0] + 1, before[1] + 2)
    cpu = ops.flat_aggregate(flat.cpu(), w.cpu(), mask=mask.cpu())
    torch.testing.assert_close(g.cpu(), cpu, **AGG_TOL)
    torch.testing.assert_close(d.cpu(), ops.client_divergence(
        flat[2:].cpu(), cpu), rtol=1e-5, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError):
        flat_aggregate(x.double(), torch.ones(4, device=cuda).double())
    with pytest.raises(ValueError):
        flat_aggregate(x.t(), torch.ones(8, device=cuda))
    with pytest.raises(ValueError):
        pairwise_l2(x, torch.zeros((2, 9), device=cuda))
    with pytest.raises(ValueError):
        pairwise_l2(x[:, ::2], torch.zeros((2, 4), device=cuda))
