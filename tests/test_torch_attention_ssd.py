"""The port's attention and SSD modules against the reference's.

On the CPU the port's wrappers take their plain PyTorch versions; those are
held against the Pallas kernels run in interpret mode (through
``repro.kernels.ops`` with ``use_pallas=True``, which does the reference's
layout changes and GQA / group repeats) and against the reference's plain
paths (``use_pallas=False``: ``ref.flash_attention_ref``, ``ref.ssd_ref``).
Tolerances: 2e-5 for attention and 1e-4 for SSD, the reference's own
kernel-test bounds in fp32; 1e-4 for gradients. Inputs are numpy draws
from a seed. The CUDA kernels' cases are in ``test_torch_cuda.py``.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _interpret(fn, *args, **kw):
    """A reference op with its Pallas kernel in interpret mode (which
    warns off-TPU by design)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*args, use_pallas=True, **kw)


def _ssd_inputs(seed, b, s, h, g, p, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    a = -rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32)
    bm = (rng.normal(size=(b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    cm = (rng.normal(size=(b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    return x, a, bm, cm


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", [
    (2, 32, 32, 8, 2, 16, True, None),        # GQA at the smoke width
    (1, 40, 40, 4, 4, 32, True, 8),           # sliding window
    (2, 8, 40, 4, 2, 16, True, None),         # Sq < Sk, right-aligned
    (1, 24, 24, 2, 1, 16, False, None),       # not causal
])
def test_plain_attention_matches_pallas_and_reference(b, sq, sk, h, kv, d,
                                                      causal, window):
    q, k, v = (_normal(1, b, sq, h, d), _normal(2, b, sk, kv, d),
               _normal(3, b, sk, kv, d))
    got = ops.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                        causal=causal, window=window).numpy()
    np.testing.assert_allclose(
        got, np.asarray(_interpret(ref_ops.attention, q, k, v, causal=causal,
                                   window=window)), **ATTN_TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref_ops.attention(q, k, v, causal=causal,
                                          window=window, use_pallas=False)),
        **ATTN_TOL)


def test_plain_attention_masked_rows_are_zero_like_the_kernel():
    """Sq > Sk leaves the first Sq - Sk queries with no key: the TPU
    kernel's clamp gives 0 there (the oracle's softmax gives NaN)."""
    q, k, v = (_normal(4, 1, 12, 2, 16), _normal(5, 1, 5, 2, 16),
               _normal(6, 1, 5, 2, 16))
    got = flash_attention(torch.tensor(q), torch.tensor(k),
                          torch.tensor(v)).numpy()
    assert np.all(got[:, :7] == 0.0)
    np.testing.assert_allclose(got, np.asarray(_interpret(
        ref_ops.attention, q, k, v, causal=True)), **ATTN_TOL)
    oracle = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(t).transpose(0, 2, 1, 3) for t in (q, k, v))))
    assert np.isnan(oracle[:, :, :7]).all()
    np.testing.assert_allclose(got[:, 7:], oracle.transpose(0, 2, 1, 3)[:, 7:],
                               **ATTN_TOL)


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", [
    (2, 32, 4, 1, 32, 16, 32),                # the smoke width
    (1, 45, 4, 2, 8, 16, 16),                 # ragged S, two groups
])
def test_plain_ssd_matches_pallas_and_reference(b, s, h, g, p, n, chunk):
    x, a, bm, cm = _ssd_inputs(s, b, s, h, g, p, n)
    y, state = ops.ssd(*(torch.tensor(t) for t in (x, a, bm, cm)),
                       chunk=chunk, n_groups=g)
    y_k, state_k = _interpret(ref_ops.ssd, x, a, bm, cm, chunk=chunk,
                              n_groups=g)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), **SSD_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(state_k), **SSD_TOL)
    rep = h // g
    y_r, state_r = jref.ssd_ref(x, a, np.repeat(bm, rep, axis=2),
                                np.repeat(cm, rep, axis=2))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **SSD_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(state_r), **SSD_TOL)


def test_attention_gradients_match_jax():
    q, k, v = (_normal(7, 2, 16, 4, 16), _normal(8, 2, 16, 2, 16),
               _normal(9, 2, 16, 2, 16))
    w = _normal(10, 2, 16, 4, 16)

    def jloss(q, k, v):
        return jnp.sum(ref_ops.attention(q, k, v, causal=True, window=6,
                                         use_pallas=False) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    loss = torch.sum(flash_attention(*leaves, causal=True, window=6)
                     * torch.tensor(w))
    for g, wg in zip(torch.autograd.grad(loss, leaves), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **GRAD_TOL)


def test_ssd_gradients_match_jax():
    x, a, bm, cm = _ssd_inputs(11, 2, 20, 4, 1, 8, 16)
    w = _normal(12, 2, 20, 4, 8)

    def jloss(x, a, bm, cm):
        y, _ = ref_ops.ssd(x, a, bm, cm, chunk=8, use_pallas=False)
        return jnp.sum(y * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(x, a, bm, cm)
    leaves = [torch.tensor(t, requires_grad=True) for t in (x, a, bm, cm)]
    y, _ = ssd_scan(*leaves, chunk=8)
    grads = torch.autograd.grad(torch.sum(y * torch.tensor(w)), leaves)
    for g, wg in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **GRAD_TOL)


def test_ref_oracles_match_the_reference_oracles():
    q, k, v = (_normal(13, 1, 3, 10, 16), _normal(14, 1, 3, 10, 16),
               _normal(15, 1, 3, 10, 16))
    np.testing.assert_allclose(
        ref.flash_attention_ref(*(torch.tensor(t) for t in (q, k, v)),
                                window=4).numpy(),
        np.asarray(jref.flash_attention_ref(q, k, v, window=4)), **ATTN_TOL)
    x, a, bm, cm = _ssd_inputs(16, 1, 12, 2, 2, 8, 4)
    for got, want in zip(ref.ssd_ref(*(torch.tensor(t)
                                       for t in (x, a, bm, cm))),
                         jref.ssd_ref(x, a, bm, cm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)
