"""The port's four kernel modules at bfloat16 against the reference's
Pallas kernels, and the bf16 carry between the two packages.

On the CPU each wrapper takes its plain PyTorch version; at bf16 those are
held against the Pallas kernels run as the reference's own bf16 tests run
them (``interpret=True``), at those tests' shapes and bf16 tolerances
(``test_kernels.py``: ``_tol`` and the pairwise bounds;
``test_flat_plane.py``'s ``flat_aggregate`` bounds; the SSD scan, which the
reference sweeps in fp32 only, at its shapes and ``_tol``). Every output
comes back in the reference kernel's dtype. ``params_from_jax`` and
``params_to_jax`` carry bf16 leaves across bit for bit. The CUDA kernels'
bf16 instances are held to their fp32 instances bit for bit in
``test_torch_cuda.py`` (on the card).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.flat_aggregate import flat_aggregate as pallas_flat_agg
from repro.kernels.pairwise_l2 import pairwise_l2 as pallas_pairwise
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flat_aggregate import flat_aggregate
from repro_torch.kernels.pairwise_l2 import divergence_sq, pairwise_l2
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.utils.trees import (params_from_jax, params_to_jax,
                                     tensor_from_numpy)

BF16_TOL = dict(rtol=2e-2, atol=2e-2)          # test_kernels.py:21 (_tol)
L2_BF16_TOL = dict(rtol=3e-2, atol=3e-1)       # test_kernels.py:40-41
AGG_BF16_TOL = dict(rtol=3e-2, atol=3e-1)      # test_flat_plane.py:216


def _bf16(seed, *shape, scale=1.0):
    """Normal draws rounded to bf16: ``(jax array, torch tensor)``, the
    same bits."""
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    j = jnp.asarray(a * scale, jnp.bfloat16)
    return j, tensor_from_numpy(np.asarray(j))


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("n,m,f", [(7, 3, 33), (100, 10, 777),
                                   (128, 128, 512), (65, 129, 1000),
                                   (1, 1, 8), (300, 5, 2240)])
def test_pairwise_l2_bf16_matches_the_pallas_kernel(n, m, f):
    (jx, tx), (jc, tc) = _bf16(n, n, f), _bf16(m + 1, m, f)
    want = pallas_pairwise(jx, jc)
    got = pairwise_l2(tx, tc)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), _f32(want), **L2_BF16_TOL)
    one = divergence_sq(tx, tc[:1])
    np.testing.assert_allclose(one.numpy(), _f32(jref.pairwise_l2_ref(
        jx, jc[:1])), **L2_BF16_TOL)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (64, 64, True, None), (100, 100, True, None), (128, 128, False, None),
    (64, 64, True, 16), (33, 170, True, None), (1, 257, True, None),
    (96, 96, True, 32)])
def test_flash_attention_bf16_matches_the_pallas_kernel(sq, sk, causal,
                                                        window):
    """The reference's layout is heads-first ``[B, H, S, D]``; the port's
    ``[B, S, H, D]``. Both give ``q.dtype``."""
    B, H, D = 2, 3, 32
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(sq * 7 + sk + i, B, H, s, D)
                                    for i, s in ((0, sq), (1, sk), (2, sk)))
    want = pallas_flash(jq, jk, jv, causal=causal, window=window, bq=32,
                        bk=32)
    got = flash_attention(*(t.transpose(1, 2) for t in (tq, tk, tv)),
                          causal=causal, window=window)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.transpose(1, 2).float().numpy(),
                               _f32(want), **BF16_TOL)


@pytest.mark.parametrize("n,p", [(7, 33), (100, 777), (128, 512),
                                 (65, 1000), (1, 8), (10, 2240)])
def test_flat_aggregate_bf16_matches_the_pallas_kernel(n, p):
    jx, tx = _bf16(n * 100 + p, n, p)
    w = np.random.default_rng(p).uniform(size=n).astype(np.float32)
    want = pallas_flat_agg(jx, jnp.asarray(w))
    got = flat_aggregate(tx, torch.tensor(w))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _f32(want), **AGG_BF16_TOL)
    # the ops guard (mask, normalise) on a bf16 plane: fp32 out
    w_t = torch.tensor(w)
    np.testing.assert_allclose(
        ops.flat_aggregate(tx, w_t).numpy(),
        (got / w_t.sum()).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s,h,p,n,g,chunk", [
    (64, 4, 32, 16, 1, 16), (100, 4, 32, 16, 2, 32), (37, 2, 16, 8, 1, 64),
    (16, 2, 8, 8, 2, 16)])
def test_ssd_scan_bf16_matches_the_pallas_kernel(s, h, p, n, g, chunk):
    """bf16 x, b, c (a fp32): y in bf16 and the state in fp32 on both
    sides; the Pallas kernel takes heads-first rows with b, c expanded, as
    the reference's ``ops.ssd`` hands them over."""
    B = 2
    jx, tx = _bf16(s + h, B, s, h, p, scale=0.5)
    jb, tb = _bf16(s + h + 1, B, s, g, n, scale=0.3)
    jc, tc = _bf16(s + h + 2, B, s, g, n, scale=0.3)
    a = -np.log1p(np.exp(np.random.default_rng(s).normal(
        size=(B, s, h)))).astype(np.float32)
    rep = h // g
    y_k, h_k = pallas_ssd(
        jx.transpose(0, 2, 1, 3).reshape(B * h, s, p),
        jnp.asarray(a).transpose(0, 2, 1).reshape(B * h, s),
        jnp.repeat(jb, rep, axis=2).transpose(0, 2, 1, 3).reshape(B * h, s,
                                                                   n),
        jnp.repeat(jc, rep, axis=2).transpose(0, 2, 1, 3).reshape(B * h, s,
                                                                   n),
        chunk=chunk)
    y, state = ssd_scan(tx, torch.tensor(a), tb, tc, chunk=chunk)
    assert (y_k.dtype, h_k.dtype) == (jnp.bfloat16, jnp.float32)
    assert (y.dtype, state.dtype) == (torch.bfloat16, torch.float32)
    np.testing.assert_allclose(
        y.float().numpy(), _f32(y_k.reshape(B, h, s, p).transpose(0, 2, 1,
                                                                  3)),
        **BF16_TOL)
    np.testing.assert_allclose(state.numpy(), _f32(h_k.reshape(B, h, p, n)),
                               **BF16_TOL)


def test_ops_on_a_bf16_plane_give_fp32():
    """The FL ops on a bf16 plane: fp32 results, as the reference's ops
    give them, within the bf16 bounds of the widened plane's."""
    jx, tx = _bf16(3, 9, 300)
    g = tx[0].float()
    div = ops.client_divergence(tx, g)
    sq = ops.client_divergence_sq(tx, g)
    d2 = ops.pairwise_sq_dists(tx, tx[:3])
    assert {div.dtype, sq.dtype, d2.dtype} == {torch.float32}
    torch.testing.assert_close(div, ops.client_divergence(tx.float(), g),
                               rtol=0, atol=0)
    torch.testing.assert_close(sq, torch.square(tx.float() - g).sum(-1),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d2.numpy(), _f32(jref.pairwise_l2_ref(
        jx, jx[:3])), **L2_BF16_TOL)


def test_ops_attention_on_bf16_returns_bf16():
    """The fault this slice repairs: on bf16 q, k, v the plain attention
    returned fp32, and the next ``@ wo`` met a bf16 weight."""
    _, q = _bf16(0, 2, 8, 4, 16)
    _, kv = _bf16(1, 2, 8, 2, 16)
    out = ops.attention(q, kv, kv)
    assert out.dtype == torch.bfloat16
    w = torch.ones((64, 8), dtype=torch.bfloat16)
    assert (out.reshape(2, 8, 64) @ w).dtype == torch.bfloat16


def test_params_carry_bf16_bit_for_bit():
    tree = {"blocks": {"w": jax.random.normal(jax.random.PRNGKey(0), (3, 5),
                                              jnp.bfloat16),
                       "a_log": jnp.arange(4, dtype=jnp.float32)},
            "embed": jax.random.normal(jax.random.PRNGKey(1), (7, 2),
                                       jnp.bfloat16)}
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    assert port["blocks/w"].dtype == torch.bfloat16
    assert port["blocks/a_log"].dtype == torch.float32
    back = params_to_jax(port)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        got = back
        for k in path:
            got = got[k.key]
        assert got.dtype == np.asarray(leaf).dtype
        assert np.array_equal(np.asarray(leaf).view(np.uint8),
                              got.view(np.uint8))
    # and back through jax
    assert jnp.asarray(back["embed"]).dtype == jnp.bfloat16
