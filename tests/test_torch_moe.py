"""The port's MoE layers and blockwise attention against the reference's,
on the CPU at the smoke widths (granite-moe's: E = 4 experts, top 2,
d = 128, F = 64).

The three MoE implementations and ``_load_balance_loss`` take the
reference's ``init_moe`` weights (numpy) and the same numpy tokens:
``dense`` and ``dense_fused`` within 1e-5, ``dispatch`` within 1e-4 at a
capacity that drops pairs, dropping the same rows. Where a case depends on
the top-k, its inputs are held to a gap of at least 1e-4 between the k-th
and (k+1)-th router logits of every token, so a flipped choice shows as
that cause and not as noise. ``blockwise_attention`` is held to the
reference's with padding, a window, ``kv_valid`` and shifted positions
(1e-5), and to itself under other tilings.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import layers as RL

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import layers as L
from repro_torch.utils.trees import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
DISPATCH_TOL = dict(rtol=1e-4, atol=1e-4)
TOPK_GAP = 1e-4
MOE = get_smoke_config("granite-moe-3b-a800m").moe
REF_MOE = ref_smoke_config("granite-moe-3b-a800m").moe
D = 128


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _moe_params(seed=0, zero_router=False):
    ref = RL.init_moe(jax.random.PRNGKey(seed), D, REF_MOE, jnp.float32)
    if zero_router:
        ref = dict(ref, router=jnp.zeros_like(ref["router"]))
    return ref, params_from_jax(jax.tree_util.tree_map(np.asarray, ref))


def _assert_topk_gap(x, router, k):
    """Every token's k-th router logit is at least ``TOPK_GAP`` above its
    (k+1)-th (float64 on the host)."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ np.asarray(
        router, np.float64)
    top = -np.sort(-logits, axis=-1)
    assert np.min(top[:, k - 1] - top[:, k]) >= TOPK_GAP


def _run(impl, ref, port, x, **kw):
    want, want_aux = RL.MOE_IMPLS[impl](ref, jnp.asarray(x), REF_MOE, **kw)
    got, got_aux = L.MOE_IMPLS[impl](port, torch.tensor(x), MOE, **kw)
    return (got.numpy(), float(got_aux)), (np.asarray(want), float(want_aux))


@pytest.mark.parametrize("impl,tol", [("dense", TOL), ("dense_fused", TOL),
                                      ("dispatch", DISPATCH_TOL)])
def test_moe_impls_match_the_reference(impl, tol):
    ref, port = _moe_params()
    x = _normal(1, 2, 16, D)
    _assert_topk_gap(x, ref["router"], MOE.top_k)
    (got, got_aux), (want, want_aux) = _run(impl, ref, port, x)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got_aux, want_aux, **TOL)
    assert got_aux > 0.0


def test_dense_fused_is_dense():
    _, port = _moe_params()
    x = torch.tensor(_normal(2, 2, 16, D))
    a, aux_a = L.moe_apply_dense(port, x, MOE)
    b, aux_b = L.moe_apply_dense_fused(port, x, MOE)
    torch.testing.assert_close(a, b, **TOL)
    assert float(aux_a) == float(aux_b)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_dispatch_drops_the_references_rows(capacity_factor):
    """At a capacity that drops pairs, the port keeps the pairs the
    reference's stable sort keeps, and the tokens whose output moves off
    the dense one are the same in both packages."""
    ref, port = _moe_params()
    x = _normal(1, 2, 16, D)
    _assert_topk_gap(x, ref["router"], MOE.top_k)
    (got, _), (want, _) = _run("dispatch", ref, port, x,
                               capacity_factor=capacity_factor)
    np.testing.assert_allclose(got, want, **DISPATCH_TOL)

    dense_p, _ = L.moe_apply_dense(port, torch.tensor(x), MOE)
    dense_r, _ = RL.moe_apply_dense(ref, jnp.asarray(x), REF_MOE)
    moved_p = np.abs(got - dense_p.numpy()).max(-1) > 1e-4
    moved_r = np.abs(want - np.asarray(dense_r)).max(-1) > 1e-4
    np.testing.assert_array_equal(moved_p, moved_r)

    # the kept (token, slot) pairs: the reference's sort, spelled in numpy
    t = x.reshape(-1, D)
    _, topi = jax.lax.top_k(jnp.asarray(t) @ ref["router"], MOE.top_k)
    topi = np.asarray(topi).reshape(-1)
    cap = L.moe_capacity(t.shape[0], MOE, capacity_factor)
    order = np.argsort(topi, kind="stable")
    e_sorted = topi[order]
    rank = np.arange(topi.size) - np.searchsorted(e_sorted, e_sorted)
    order_p, _, _, keep_p = L.dispatch_slots(torch.tensor(topi).reshape(
        -1, MOE.top_k), MOE.num_experts, cap)
    np.testing.assert_array_equal(order_p.numpy(), order)
    np.testing.assert_array_equal(keep_p.numpy(), rank < cap)
    if capacity_factor < 1.0:
        assert not (rank < cap).all() and moved_r.any()


def test_dispatch_without_drops_is_dense():
    """At ``capacity_factor = E / k`` no pair is dropped: dispatch is the
    dense MoE."""
    _, port = _moe_params()
    x = torch.tensor(_normal(3, 2, 16, D))
    full = MOE.num_experts / MOE.top_k
    got, aux = L.moe_apply_dispatch(port, x, MOE, capacity_factor=full)
    want, want_aux = L.moe_apply_dense(port, x, MOE)
    torch.testing.assert_close(got, want, **DISPATCH_TOL)
    assert float(aux) == float(want_aux)


def test_dispatch_repeats_bit_for_bit():
    _, port = _moe_params()
    x = torch.tensor(_normal(4, 2, 16, D))
    a, _ = L.moe_apply_dispatch(port, x, MOE, capacity_factor=0.5)
    b, _ = L.moe_apply_dispatch(port, x, MOE, capacity_factor=0.5)
    assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_tied_router_picks_the_references_experts(impl):
    """All router weights 0: every logit ties, and the lower expert index
    wins, as ``lax.top_k`` ranks. Every token goes to experts 0 and 1, so
    ``dispatch`` drops the pairs past capacity in token order."""
    ref, port = _moe_params(zero_router=True)
    x = _normal(5, 2, 16, D)
    t = torch.tensor(x.reshape(-1, D))
    _, topw, topi, _ = L._route(port, t, MOE)
    assert (topi == torch.arange(MOE.top_k)).all()
    torch.testing.assert_close(topw, torch.full_like(topw, 1 / MOE.top_k))
    (got, got_aux), (want, want_aux) = _run(impl, ref, port, x)
    np.testing.assert_allclose(got, want, **DISPATCH_TOL)
    np.testing.assert_allclose(got_aux, want_aux, **TOL)


def test_load_balance_loss_matches_the_reference():
    logits = _normal(6, 32, MOE.num_experts)
    _, topi = jax.lax.top_k(jnp.asarray(logits), MOE.top_k)
    want = RL._load_balance_loss(jnp.asarray(logits), topi, REF_MOE)
    got = L._load_balance_loss(torch.tensor(logits),
                               torch.tensor(np.asarray(topi)).long(), MOE)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_init_moe_has_the_references_shapes():
    ref, _ = _moe_params()
    got = L.init_moe(torch.Generator().manual_seed(0), D, MOE, "cpu", 3)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == (3,) + v.shape


# ---------------------------------------------------------------------------
# blockwise attention
# ---------------------------------------------------------------------------


ATTN_CASES = {
    # name: (Sq, Sk, causal, window, kv_valid, q offset, q_chunk, kv_chunk)
    "causal, both padded": (37, 37, True, None, False, 0, 16, 8),
    "window": (40, 40, True, 10, False, 0, 16, 16),
    "non-causal, kv_valid, Sq != Sk": (20, 45, False, None, True, 0, 8, 16),
    "shifted queries": (5, 45, True, 12, True, 40, 4, 16),
}


def _attn_inputs(sq, sk, seed=7, h=8, kv=2, d=16):
    return (_normal(seed, 2, sq, h, d), _normal(seed + 1, 2, sk, kv, d),
            _normal(seed + 2, 2, sk, kv, d))


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_blockwise_attention_matches_the_reference(case):
    sq, sk, causal, window, valid, shift, qc, kc = ATTN_CASES[case]
    q, k, v = _attn_inputs(sq, sk)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    pos = {}
    if shift:
        pos = dict(q_positions=np.arange(shift, shift + sq),
                   k_positions=np.arange(sk))
    if valid:
        pos["kv_valid"] = np.random.default_rng(9).random(sk) < 0.8
    want = RL.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: jnp.asarray(a) for n, a in pos.items()}, **kw)
    got = L.blockwise_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        **{n: torch.tensor(a) for n, a in pos.items()}, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 9),
                                           (False, None)])
def test_blockwise_attention_does_not_depend_on_its_tiling(causal, window):
    """Other chunk sizes (padded or not) give the same attention, which is
    the kernel's plain version's on aligned positions."""
    q, k, v = (torch.tensor(a) for a in _attn_inputs(33, 33, seed=11))
    outs = [L.blockwise_attention(q, k, v, causal=causal, window=window,
                                  q_chunk=qc, kv_chunk=kc)
            for qc, kc in ((64, 64), (16, 8), (7, 5), (1, 33))]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], **TOL)
    torch.testing.assert_close(outs[0], flash_attention_plain(
        q, k, v, causal=causal, window=window), **TOL)


def test_cross_attention_projects_kv_from_memory():
    """``attention_qkv(..., kv_x=memory)``: q from x, k and v from the
    memory, as the reference's."""
    cfg = get_smoke_config("seamless-m4t-medium")
    ref_cfg = ref_smoke_config("seamless-m4t-medium")
    ref = RL.init_attention(jax.random.PRNGKey(2), ref_cfg, jnp.float32)
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, ref))
    x, mem = _normal(12, 2, 6, cfg.d_model), _normal(13, 2, 9, cfg.d_model)
    want = RL.attention_qkv(ref, jnp.asarray(x), ref_cfg,
                            kv_x=jnp.asarray(mem))
    got = L.attention_qkv(port, torch.tensor(x), cfg,
                          kv_x=torch.tensor(mem))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
