"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every case is marked ``cuda`` and skips where there
is no card; the file imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib

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


@pytest.mark.parametrize("n,p,nan_at", [
    (1, 4096, ()),                             # one row
    (13, 4100, (0, 6, 12)),                    # N not a multiple of 8
    (100, 1003, (0, 50, 99)),                  # P % 4 != 0: scalar path
    (300, 2052, (0, 150, 299)),                # two 256-row chunks
])
def test_flat_aggregate_edges(cuda, n, p, nan_at):
    """NaN rows at weight 0 first, in the middle and last; a second call
    is equal bit for bit."""
    flat = torch.tensor(_normal(n + p, n, p), device=cuda)
    w = torch.tensor(np.abs(_normal(n + 2, n)) + 0.1, device=cuda)
    for i in nan_at:                           # NaN rows at weight 0
        flat[i] = float("nan")
        w[i] = 0.0
    got = flat_aggregate(flat, w)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, flat_aggregate_plain(flat, w), **AGG_TOL)
    assert torch.equal(flat_aggregate(flat, w), got)     # bit for bit


def test_flat_aggregate_all_weights_zero(cuda):
    flat = torch.tensor(_normal(4, 12, 1000), device=cuda)
    flat[3] = float("nan")
    w = torch.zeros(12, device=cuda)
    for x in (flat, flat[:, 1:]):              # float4 and scalar paths
        got = flat_aggregate(x.contiguous(), w)
        torch.cuda.synchronize()
        assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("n,m,f", [(40, 10, 2240), (40, 1, 113_744),
                                   (7, 3, 33), (1, 1, 8),
                                   (10, 1, 563_200),   # F split into slabs
                                   (10, 4, 22_528),
                                   (3, 1, 50_001)])    # split, f % 4 != 0
def test_pairwise_l2_matches_plain(cuda, n, m, f):
    """One call per wrapper call (one or two device launches); a second
    call is equal bit for bit."""
    x = torch.tensor(_normal(n, n, f), device=cuda)
    c = torch.tensor(_normal(m + 100, m, f), device=cuda)
    before = pairwise_l2.launches
    got = pairwise_l2(x, c)
    torch.cuda.synchronize()
    assert pairwise_l2.launches == before + 1
    torch.testing.assert_close(got, ref.pairwise_l2_ref(x, c), **L2_TOL)
    assert torch.equal(pairwise_l2(x, c), got)           # bit for bit


def test_pairwise_l2_misaligned_view(cuda):
    """A contiguous view whose rows are not 16-byte aligned takes the
    scalar path, split into slabs at M = 1."""
    n, f = 5, 40_000
    base = torch.tensor(_normal(11, n * f + 1), device=cuda)
    x = base[1:].view(n, f)
    c = torch.tensor(_normal(12, 1, f), device=cuda)
    got = pairwise_l2(x, c)
    torch.cuda.synchronize()
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


ATTN_TOL = dict(rtol=2e-5, atol=2e-5)     # fp32, another summation order
SSD_TOL = dict(rtol=1e-4, atol=1e-4)      # the reference's ssd_ref bound


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", [
    (8, 32, 32, 32, 4, 64, True, None),        # the FL path (tinyllama)
    (2, 32, 32, 8, 2, 16, True, None),         # the smoke width
    (1, 2048, 2048, 32, 4, 64, True, None),
    (1, 2048, 2048, 32, 4, 64, True, 512),
    (1, 1, 2048, 32, 4, 64, True, None),       # one query, right-aligned
    (2, 96, 40, 4, 4, 32, True, None),         # Sq > Sk: masked rows give 0
    (2, 70, 130, 4, 1, 128, False, 50),
])
def test_flash_attention_matches_plain(cuda, b, sq, sk, h, kv, d, causal,
                                       window):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q = torch.tensor(_normal(1, b, sq, h, d), device=cuda)
    k = torch.tensor(_normal(2, b, sk, kv, d), device=cuda)
    v = torch.tensor(_normal(3, b, sk, kv, d), device=cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, **ATTN_TOL)
    if sq > sk:
        assert torch.count_nonzero(got[:, :sq - sk]) == 0


@pytest.mark.parametrize("b,sq,sk,h,kv,d,window", [
    (1, 1, 2048, 32, 4, 64, None),             # split key tiles
    (1, 1, 2047, 32, 4, 64, None),
    (1, 3, 2048, 32, 4, 64, 300),
    (1, 3, 2047, 32, 4, 64, None),
    (2, 1, 2047, 8, 8, 64, 1000),              # H / K = 1
    (1, 37, 300, 16, 8, 32, None),             # H / K = 2, Sq * G % 64 != 0
    (3, 29, 29, 16, 2, 16, None),              # H / K = 8
    (2, 50, 600, 8, 1, 128, 128),              # D = 128
    (1, 2, 5000, 4, 2, 16, None),              # D = 16, many chunks
])
def test_flash_attention_plan_shapes(cuda, b, sq, sk, h, kv, d, window):
    """Split key tiles, GQA-packed rows and both tile widths against the
    plain version; a second call is equal bit for bit."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     plan_attention)
    q = torch.tensor(_normal(4, b, sq, h, d), device=cuda)
    k = torch.tensor(_normal(5, b, sk, kv, d), device=cuda)
    v = torch.tensor(_normal(6, b, sk, kv, d), device=cuda)
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, **ATTN_TOL)
    assert torch.equal(flash_attention(q, k, v, causal=True, window=window),
                       got)
    if sq <= 3:
        assert plan_attention(b, sq, sk, h, kv, True, window).chunks > 1


@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (8, 128, 128, 16, 16, 64),                 # seamless's encoder (train)
    (4, 32, 32, 16, 16, 64),                   # its serve batch
    (2, 20, 45, 8, 2, 16),                     # Sq < Sk
    (2, 45, 20, 6, 2, 32),                     # Sq > Sk: every row has keys
])
def test_flash_attention_non_causal_matches_plain(cuda, b, sq, sk, h, kv,
                                                  d):
    """The encoder's self-attention: no causal mask, at Sq = Sk and Sq !=
    Sk; a second call is equal bit for bit."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q = torch.tensor(_normal(21, b, sq, h, d), device=cuda)
    k = torch.tensor(_normal(22, b, sk, kv, d), device=cuda)
    v = torch.tensor(_normal(23, b, sk, kv, d), device=cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got, flash_attention_plain(q, k, v,
                                                          causal=False),
                               **ATTN_TOL)
    assert torch.count_nonzero(got.abs().sum(-1)) == b * sq * h
    assert torch.equal(flash_attention(q, k, v, causal=False), got)


@pytest.mark.parametrize("b,s,h,kv,d,window", [
    (8, 128, 24, 8, 64, None),                 # granite: H / K = 3
    (2, 64, 12, 2, 128, None),                 # qwen2: H / K = 6, D = 128
    (1, 300, 48, 8, 128, 128),                 # mixtral: H / K = 6, window
])
def test_flash_attention_new_gqa_ratios(cuda, b, s, h, kv, d, window):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q = torch.tensor(_normal(24, b, s, h, d), device=cuda)
    k = torch.tensor(_normal(25, b, s, kv, d), device=cuda)
    v = torch.tensor(_normal(26, b, s, kv, d), device=cuda)
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, flash_attention_plain(
        q, k, v, causal=True, window=window), **ATTN_TOL)
    assert torch.equal(flash_attention(q, k, v, causal=True, window=window),
                       got)


def test_flash_attention_refuses_phi3_head_dim(cuda):
    """phi-3-vision's head dim 96 is no template instance: its published
    width raises the kernel's ``ValueError`` on the card, through the
    model too, and launches nothing."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.transformer import forward, init_model
    q = torch.zeros((1, 8, 32, 96), device=cuda)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    cfg = get_config("phi-3-vision-4.2b").replace(num_layers=1)
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                        cuda)
    with pytest.raises(ValueError, match="head dims"), torch.no_grad():
        forward(cfg, params, {"tokens": torch.zeros(
            (1, 8), dtype=torch.int64, device=cuda)})
    assert flash_attention.launches == before


def test_flash_attention_unaligned_kv(cuda):
    """K/V views whose rows are not 16-byte aligned take the 4-byte
    copies."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q = torch.tensor(_normal(7, 2, 40, 8, 32), device=cuda)
    kv = torch.tensor(_normal(8, 2, 90, 2, 33), device=cuda)
    k, v = kv[..., 1:], kv[..., :32]
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, flash_attention_plain(q, k, v),
                               **ATTN_TOL)


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", [
    (8, 32, 24, 1, 64, 128, 256),              # the FL path (mamba2-130m)
    (2, 32, 8, 1, 32, 16, 32),                 # the smoke width
    (1, 2048, 24, 1, 64, 128, 256),
    (1, 300, 24, 1, 64, 128, 256),             # ragged S
    (2, 77, 4, 2, 8, 24, 16),                  # groups, ragged, odd N
    (1, 512, 4, 1, 64, 128, 128),              # S a multiple of Q, 4 chunks
    (1, 200, 2, 1, 16, 18, 16),                # 13 chunks, N % 4 != 0
    (2, 50, 3, 3, 72, 17, 8),                  # odd N, P > 64, G = H
])
def test_ssd_scan_matches_plain(cuda, b, s, h, g, p, n, chunk):
    """One call per wrapper call (one device launch for one chunk, three
    for more); a second call is equal bit for bit."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    rng = np.random.default_rng(s + n)
    x = torch.tensor(rng.normal(size=(b, s, h, p)).astype(np.float32),
                     device=cuda)
    a = torch.tensor(-rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32),
                     device=cuda)
    bm = torch.tensor((rng.normal(size=(b, s, g, n)) / np.sqrt(n))
                      .astype(np.float32), device=cuda)
    cm = torch.tensor((rng.normal(size=(b, s, g, n)) / np.sqrt(n))
                      .astype(np.float32), device=cuda)
    before = ssd_scan.launches
    y, state = ssd_scan(x, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    y_ref, state_ref = ssd_scan_plain(x, a, bm, cm)
    torch.testing.assert_close(y, y_ref, **SSD_TOL)
    torch.testing.assert_close(state, state_ref, **SSD_TOL)
    y2, state2 = ssd_scan(x, a, bm, cm, chunk=chunk)
    assert torch.equal(y2, y) and torch.equal(state2, state)


@pytest.mark.parametrize("s", [16, 64])
def test_ssd_scan_at_jamba_smoke_dims(cuda, s):
    """jamba's smoke mamba layers: H = 8, P = 32, N = 16, chunk 32 (one
    chunk, and two)."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    rng = np.random.default_rng(s)
    b, h, p, n = 4, 8, 32, 16
    x = torch.tensor(rng.normal(size=(b, s, h, p)).astype(np.float32),
                     device=cuda)
    a = torch.tensor(-rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32),
                     device=cuda)
    bm, cm = (torch.tensor((rng.normal(size=(b, s, 1, n)) / np.sqrt(n))
                           .astype(np.float32), device=cuda)
              for _ in range(2))
    y, state = ssd_scan(x, a, bm, cm, chunk=32)
    torch.cuda.synchronize()
    y_ref, state_ref = ssd_scan_plain(x, a, bm, cm)
    torch.testing.assert_close(y, y_ref, **SSD_TOL)
    torch.testing.assert_close(state, state_ref, **SSD_TOL)


@pytest.mark.parametrize("width", ["smoke", "published"])
def test_moe_dispatch_repeats_bit_for_bit(cuda, width):
    """The MoE dispatch on the card: a second call gives the same bits
    (one slot a pair, each token's k results summed in slot order; no
    atomic scatter-add), and at capacity E / k it is the dense MoE within
    1e-4. At the smoke width it is the CPU's within 1e-4 too (at the
    published width's 40 experts a router logit's last bits may reorder a
    near tie between the two devices)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import layers as L
    cfg = (get_smoke_config if width == "smoke" else get_config)(
        "granite-moe-3b-a800m")
    moe = cfg.moe
    p = {k: v[0] for k, v in L.init_moe(torch.Generator().manual_seed(0),
                                         cfg.d_model, moe, "cpu", 1).items()}
    x = torch.tensor(_normal(27, 8, 128, cfg.d_model))
    on = {k: v.to(cuda) for k, v in p.items()}
    with torch.no_grad():
        a, aux_a = L.moe_apply_dispatch(on, x.to(cuda), moe)
        b, aux_b = L.moe_apply_dispatch(on, x.to(cuda), moe)
        want, _ = L.moe_apply_dispatch(p, x, moe)       # on the CPU
        full = moe.num_experts / moe.top_k
        nodrop, _ = L.moe_apply_dispatch(on, x.to(cuda), moe,
                                         capacity_factor=full)
        dense, _ = L.moe_apply_dense(on, x.to(cuda), moe)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    torch.testing.assert_close(nodrop, dense, rtol=1e-4, atol=1e-4)
    if width == "smoke":
        torch.testing.assert_close(a.cpu(), want, rtol=1e-4, atol=1e-4)


def test_ssd_scan_strided_and_misaligned_views(cuda):
    """b and c as views of one projection (as ``mamba2_apply`` passes
    them), then views off the 16-byte grid, which take 4-byte copies."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    rng = np.random.default_rng(5)
    b_, s, h, p, n = 2, 70, 4, 16, 24
    x = torch.tensor(rng.normal(size=(b_, s, h, p)).astype(np.float32),
                     device=cuda)
    a = torch.tensor(-rng.uniform(0.01, 0.3, (b_, s, h)).astype(np.float32),
                     device=cuda)
    proj = torch.tensor((rng.normal(size=(b_, s, 1, 2 * n + 1)) / np.sqrt(n))
                        .astype(np.float32), device=cuda)
    for bm, cm in ((proj[..., :n], proj[..., n:2 * n]),
                   (proj[..., 1:n + 1], proj[..., n + 1:])):
        y, state = ssd_scan(x, a, bm, cm, chunk=32)
        torch.cuda.synchronize()
        y_ref, state_ref = ssd_scan_plain(x, a, bm, cm)
        torch.testing.assert_close(y, y_ref, **SSD_TOL)
        torch.testing.assert_close(state, state_ref, **SSD_TOL)


@pytest.mark.parametrize("change", [
    dict(y_blocks=-1), dict(state_blocks=1), dict(row_tiles=1),
    dict(chunks=1), dict(y_smem=-16), dict(state_smem=-16)])
def test_ssd_scan_refuses_a_plan_that_is_not_its_grid(cuda, monkeypatch,
                                                      change):
    """The kernel takes its grid and shared memory from ``plan_ssd`` and
    checks them against its block decode and layout: a plan off by one
    block, tile, chunk or 16 bytes is refused, and nothing is counted."""
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    x = torch.zeros((1, 300, 2, 64), device=cuda)        # two chunks
    a = torch.zeros((1, 300, 2), device=cuda)
    bc = torch.zeros((1, 300, 1, 128), device=cuda)
    plan = ss.plan_ssd

    def off(*args):
        p = plan(*args)
        return p._replace(**{k: getattr(p, k) + d for k, d in change.items()})

    monkeypatch.setattr(ss, "plan_ssd", off)
    before = ss.ssd_scan.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ss.ssd_scan(x, a, bc, bc)
    assert ss.ssd_scan.launches == before


def test_kernel_gradients_are_the_plain_versions(cuda):
    """The autograd Functions: values from the kernels; gradients, from
    differentiating the plain version (attention) or the chunked form
    (SSD), equal to those of the plain versions on the same inputs."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    rng = np.random.default_rng(0)

    def leaf(*shape, scale=1.0):
        return torch.tensor((rng.normal(size=shape) * scale)
                            .astype(np.float32), device=cuda,
                            requires_grad=True)

    q, k, v = leaf(2, 32, 8, 16), leaf(2, 32, 2, 16), leaf(2, 32, 2, 16)
    w = torch.tensor(_normal(9, 2, 32, 8, 16), device=cuda)
    got = torch.autograd.grad((fa.flash_attention(q, k, v) * w).sum(),
                              (q, k, v))
    want = torch.autograd.grad((fa.flash_attention_plain(q, k, v) * w).sum(),
                               (q, k, v))
    for g1, g2 in zip(got, want):
        torch.testing.assert_close(g1, g2, **ATTN_TOL)
    x, bm, cm = leaf(2, 40, 4, 8), leaf(2, 40, 1, 16), leaf(2, 40, 1, 16)
    a = (-torch.rand((2, 40, 4), device=cuda) * 0.3).requires_grad_(True)
    got = torch.autograd.grad(ss.ssd_scan(x, a, bm, cm, chunk=16)[0].sum(),
                              (x, a, bm, cm))
    want = torch.autograd.grad(ss.ssd_scan_plain(x, a, bm, cm)[0].sum(),
                               (x, a, bm, cm))
    for g1, g2 in zip(got, want):
        torch.testing.assert_close(g1, g2, **SSD_TOL)


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
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    q = torch.zeros((1, 4, 2, 24), device=cuda)          # D = 24: not built
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(q[..., :16].double(), q[..., :16].double(),
                        q[..., :16].double())
    x = torch.zeros((1, 4, 2, 12), device=cuda)          # P = 12: no slice
    with pytest.raises(ValueError):
        ssd_scan(x, torch.zeros((1, 4, 2), device=cuda),
                 torch.zeros((1, 4, 1, 8), device=cuda),
                 torch.zeros((1, 4, 1, 8), device=cuda))


def test_fedl_graph_matches_its_eager_solve(cuda):
    """FEDL's captured CUDA graph against its body run eagerly on the card,
    at two λ through one capture and with a padding mask; the CPU solve
    is the third yardstick."""
    from repro_torch.core import baselines as bl
    from repro_torch.core.wireless import fleet_arrays, sample_fleet
    fleet = sample_fleet(100, seed=1).select(np.arange(10))
    arr = fleet_arrays(fleet, cuda)
    mask = torch.arange(10, device=cuda) < 7
    bl._GRAPHS.clear()
    # a shape's first solve runs eager, its second captures
    for lam, m in ((4.58, None), (0.2, None), (1.0, mask), (4.58, mask)):
        got = bl.fedl_lambda(arr, 20.0, lam, 60, mask=m)
        want = bl._fedl_solve(bl.effective_arrays(arr), 20.0, lam, 60, m)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        if m is None:
            cpu = bl.fedl_lambda(fleet_arrays(fleet), 20.0, lam, 60)
            torch.testing.assert_close(float(torch.sum(got.e) + lam * got.T),
                                       float(torch.sum(cpu.e) + lam * cpu.T),
                                       rtol=1e-3, atol=0)
    assert len(bl._GRAPHS.graphs) == 2


def test_sao_graph_matches_its_eager_solve(cuda):
    """SAO's captured CUDA graph against its body run eagerly on the card,
    bit for bit: with and without the box correction and a padding mask,
    two fleets through one capture (a shape's first solve runs eager, its
    second captures); the CPU solve within SAO's band."""
    from repro_torch.core import sao
    from repro_torch.core.graphs import eager_solves
    from repro_torch.core.sao import solve_sao
    from repro_torch.core.wireless import fleet_arrays, sample_fleet
    mask = torch.arange(10, device=cuda) < 7
    sao._GRAPHS.clear()
    for seed in (1, 2, 3):
        fleet = sample_fleet(100, seed=seed).select(np.arange(10))
        arr = fleet_arrays(fleet, cuda)
        for box in (False, True):
            for m in (None, mask):
                got = solve_sao(arr, 20.0, mask=m, box_correct=box)
                with eager_solves():
                    want = solve_sao(arr, 20.0, mask=m, box_correct=box)
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=0, atol=0)
        got, cpu = solve_sao(arr, 20.0), solve_sao(fleet_arrays(fleet), 20.0)
        torch.testing.assert_close(float(got.T), float(cpu.T), rtol=2e-3,
                                   atol=0)
    assert len(sao._GRAPHS.graphs) == 4


def test_graph_cache_captures_a_shape_at_its_second_solve(cuda):
    """A shape met once runs eager and holds no graph; the second solve
    captures it; the cache keeps at most ``max_graphs``, the least
    recently used going first."""
    from repro_torch.core import sao
    from repro_torch.core.sao import solve_sao
    from repro_torch.core.wireless import fleet_arrays, sample_fleet
    arr = fleet_arrays(sample_fleet(100, seed=1), cuda)
    sao._GRAPHS.clear()
    solve_sao({k: v[:5] for k, v in arr.items()}, 20.0)
    assert not sao._GRAPHS.graphs
    for s in list(range(2, 11)) * 2:
        solve_sao({k: v[:s] for k, v in arr.items()}, 20.0)
    held = [key[1] for key in sao._GRAPHS.graphs]
    assert held == list(range(3, 11)) and sao._GRAPHS.max_graphs == 8


def test_replayed_round_matches_the_eager_round_body(cuda):
    """One replay of the captured round against the same round body run
    eagerly on the same carry, inputs and batch indices."""
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.core import engine
    from repro_torch.core.graphs import eager_solves
    from repro_torch.core.wireless import fleet_arrays
    spec = ExperimentSpec(dataset="fashion", clients=8, samples_per_client=16,
                          train_samples=160, test_samples=80, local_iters=2,
                          batch_size=8, rounds=1, devices_per_round=4,
                          num_clusters=4)
    exp = build_experiment(spec, device=cuda)
    hist = exp.run()                    # the initial round + one replay
    assert hist.seconds == [] and len(hist.accuracy) == 2
    prog = engine.run_rounds(
        exp.engine_cfg, selector=exp.selector, allocator=exp.allocator,
        aggregator=exp.aggregator, tctx=exp.traced_context(),
        feature_layer=exp.fl.feature_layer, device=exp.device,
        shapes=engine.shapes_key((exp._images, exp._labels, exp._sizes,
                                  exp.test_images, exp.test_labels)))
    assert prog.graph is not None and prog.capture_ms > 0
    inputs = engine.RoundInputs(exp._images, exp._labels, exp._sizes,
                                fleet_arrays(exp.fleet, cuda),
                                exp.test_images, exp.test_labels)
    batch = exp.draws.batch_indices(prog.pad, 2, 8, 16)
    prog.load(exp.traced_state(), inputs)
    got = [None if t is None else t.clone() for t in prog.replay(batch)]
    got_state = [t.clone() for t in (prog.state.params,
                                     prog.state.client_params)]
    state = exp.traced_state()
    with eager_solves():
        state, want = prog.round_body(state, inputs, batch)
    torch.cuda.synchronize()
    for name, g, w in zip(engine.RoundOutputs._fields, got, want):
        if w is None:                   # inr: no dynamic interference here
            assert g is None, name
            continue
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6, msg=name)
    for g, w in zip(got_state, (state.params, state.client_params)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the lane forms (a cohort's seeds): one launch for every lane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,p", [(8, 10, 113_744), (3, 13, 4100),
                                   (2, 300, 1003), (5, 1, 8)])
def test_flat_aggregate_lanes_match_plain(cuda, b, n, p):
    """[B, N, P] × [B, N] in one launch, each lane equal bit for bit to
    the 2-D call on that lane (the lane is a grid axis, nothing else)."""
    flat = torch.tensor(_normal(b + n, b, n, p), device=cuda)
    w = torch.tensor(np.abs(_normal(b + n + 1, b, n)) + 0.1, device=cuda)
    if n > 1:
        flat[:, n // 2] = float("nan")             # NaN rows at weight 0
        w[:, n // 2] = 0.0
    before = flat_aggregate.launches
    got = flat_aggregate(flat, w)
    torch.cuda.synchronize()
    assert flat_aggregate.launches == before + 1 and got.shape == (b, p)
    torch.testing.assert_close(got, flat_aggregate_plain(flat, w), **AGG_TOL)
    for i in range(b):
        assert torch.equal(got[i], flat_aggregate(flat[i], w[i]))


@pytest.mark.parametrize("b,n,rows,m,f", [(8, 40, 50, 1, 113_744),
                                          (8, 40, 40, 10, 2240),
                                          (3, 7, 9, 3, 33),
                                          (2, 10, 12, 1, 563_200)])
def test_pairwise_l2_lanes_match_plain(cuda, b, n, rows, m, f):
    """[B, N, F] × [B, M, F] in one call, x the first N rows of each lane
    of a [B, rows, F] plane (each lane at its stride); each lane equal
    bit for bit to the 2-D call on that lane's rows (the same slab
    plan)."""
    plane = torch.tensor(_normal(b + f, b, rows, f), device=cuda)
    x = plane[:, :n]
    c = torch.tensor(_normal(b + m, b, m, f), device=cuda)
    before = pairwise_l2.launches
    got = pairwise_l2(x, c)
    torch.cuda.synchronize()
    assert pairwise_l2.launches == before + 1 and got.shape == (b, n, m)
    torch.testing.assert_close(got, ref.pairwise_l2_ref(x, c), **L2_TOL)
    for i in range(b):
        assert torch.equal(got[i], pairwise_l2(x[i], c[i]))


def test_ops_lanes_on_cuda(cuda):
    flat = torch.tensor(_normal(3, 4, 6, 4096), device=cuda)
    w = torch.tensor(np.abs(_normal(4, 4, 6)) + 0.1, device=cuda)
    mask = torch.rand((4, 6), device=cuda) > 0.3
    g = ops.flat_aggregate(flat, w, mask=mask)
    d = ops.client_divergence(flat, g)
    torch.cuda.synchronize()
    cpu = ops.flat_aggregate(flat.cpu(), w.cpu(), mask=mask.cpu())
    torch.testing.assert_close(g.cpu(), cpu, **AGG_TOL)
    torch.testing.assert_close(d.cpu(), ops.client_divergence(
        flat.cpu(), cpu), rtol=1e-5, atol=1e-5)


def test_cohort_on_the_card_matches_single_runs(cuda):
    """A cohort of 2 as lanes of one captured round against its seeds'
    single traced runs on the card."""
    from repro_torch.api import ExperimentSpec, build_cohort, build_experiment
    spec = ExperimentSpec(dataset="fashion", clients=8, samples_per_client=16,
                          train_samples=160, test_samples=80, local_iters=2,
                          batch_size=8, rounds=2, devices_per_round=4,
                          num_clusters=4, cohort=2, data_seed=7,
                          test_seed=90_000)
    runner = build_cohort(spec, device=cuda)
    ch = runner.run(transfer_guard=True)
    assert runner.program.graph is not None and runner.program.lanes == 2
    for i, seed in enumerate(ch.seeds):
        single = build_experiment(spec.replace(seed=seed), device=cuda)
        h = single.run()
        hi = ch.history(i)
        for a, b in zip(hi.selected, h.selected):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(hi.T_k, h.T_k, rtol=1e-5)
        np.testing.assert_allclose(hi.E_k, h.E_k, rtol=1e-5)
        assert max(abs(x - y) for x, y in zip(hi.accuracy, h.accuracy)) \
            <= 1.0 / 80 + 1e-9
        torch.testing.assert_close(runner.experiments[i].global_vec,
                                   single.global_vec, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the wireless scenario: fading, interference, FedAvgM and compression
# ---------------------------------------------------------------------------


TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=3, devices_per_round=4, num_clusters=4)


class CpuDraws:
    """The default draws made on the CPU and moved to ``device``: one seed
    gives a CPU run and a card run the same numbers."""

    def __init__(self, seed, device):
        from repro_torch.core.draws import TorchDraws
        self.inner = TorchDraws(seed, "cpu")
        self.device = device

    def init_params(self, model_cfg):
        return {k: v.to(self.device)
                for k, v in self.inner.init_params(model_cfg).items()}

    def batch_indices(self, *args):
        return self.inner.batch_indices(*args).to(self.device)

    def channel_init(self, shape):
        return self.inner.channel_init(shape).to(self.device)

    def channel_step(self, shape):
        return self.inner.channel_step(shape).to(self.device)

    def kmeans_seed(self, n, c):
        return self.inner.kmeans_seed(n, c).to(self.device)

    def kmeans_choice(self, i, p):
        return self.inner.kmeans_choice(i, p.cpu()).to(self.device)


def _rows_close(got, want):
    """Within 1e-5, but for the entries an int8 rounding flipped (one
    quantization step: at most 0.1 % of them, each within 1e-3)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.count_nonzero(np.abs(got - want) > 1e-5) <= 1e-3 * got.size
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_dynamic_cell_cohort_on_the_card_matches_the_cpu(cuda):
    """A 2-cell ``multicell-dynamic`` (ρ = 0.9) cohort with FedAvgM and
    int8, one captured round for both cells, against the same cohort on
    the CPU from the same draws."""
    from repro_torch.api import ExperimentSpec, build_cohort
    from repro_torch.api.scenario import multicell_fleet_spec
    spec = ExperimentSpec(**TINY, cohort=1, aggregator="fedavgm:0.9",
                          compressor="int8", fleet=multicell_fleet_spec(
                              2, channel={"name": "multicell-dynamic",
                                          "params": {"rho": 0.9}}))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        runner = build_cohort(spec, device=dev,
                              draws=lambda s, dev=dev: CpuDraws(s, dev))
        runs.append((runner, runner.run()))
    (card, ch), (cpu, ch_cpu) = runs
    assert card.program.graph is not None and card.program.lanes == 2
    np.testing.assert_array_equal(ch.selected * ch.mask,
                                  ch_cpu.selected * ch_cpu.mask)
    np.testing.assert_allclose(ch.T_k, ch_cpu.T_k, rtol=1e-5)
    np.testing.assert_allclose(ch.E_k, ch_cpu.E_k, rtol=1e-5)
    np.testing.assert_allclose(ch.inr, ch_cpu.inr, rtol=1e-5)
    assert np.all(ch.inr > 0)
    for a, b in zip(card.experiments, cpu.experiments):
        _rows_close(a.global_vec, b.global_vec)


def test_fedavgm_replays_equal_eager_rounds(cuda):
    """Three replays of a captured FedAvgM round (the momentum written in
    place in the graph's carry) against three eager runs of the same round
    body from the same carry and batch indices."""
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.core.graphs import eager_solves
    spec = ExperimentSpec(**TINY, aggregator="fedavgm:0.9", compressor="int8")
    exp = build_experiment(spec, device=cuda)
    from repro_torch.core import engine
    exp.run(rounds=1)                    # the initial round + one replay
    inputs = exp.traced_inputs()
    prog = engine.run_rounds(
        exp.engine_cfg, selector=exp.selector, allocator=exp.allocator,
        aggregator=exp.aggregator, tctx=exp.traced_context(),
        feature_layer=exp.fl.feature_layer, device=exp.device,
        shapes=inputs.shapes(), compressor=exp.compressor,
        channel=exp.channel)
    assert prog.graph is not None
    batches = [exp.draws.batch_indices(prog.pad, 2, 8, 16) for _ in range(3)]
    state0 = exp.traced_state()
    assert float(torch.max(torch.abs(state0.opt_state))) > 0
    prog.load(state0, inputs)
    for b in batches:
        prog.replay(b)
    got = [t.clone() for t in (prog.state.params, prog.state.opt_state,
                               prog.state.client_params)]
    state = exp.traced_state()
    with eager_solves():
        for b in batches:
            state, _ = prog.round_body(state, inputs, b)
    torch.cuda.synchronize()
    for g, w in zip(got, (state.params, state.opt_state,
                          state.client_params)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the paged client store
# ---------------------------------------------------------------------------


def test_divergence_bits_do_not_depend_on_the_rows_in_the_call(cuda):
    """The one-centroid call's slab plan is a function of P alone: each
    row's divergence is the same bits alone, in a chunk or in the plane
    (``plan_slabs`` of n gave 14, 4 and 1 slabs at n = 40, 147, 600)."""
    plane = torch.tensor(_normal(11, 600, 113_744), device=cuda)
    g = torch.tensor(_normal(12, 113_744), device=cuda)
    whole = ops.client_divergence(plane, g)
    for chunk in (1, 10, 40, 128, 147):
        parts = torch.cat([ops.client_divergence(plane[s:s + chunk], g)
                           for s in range(0, 600, chunk)])
        assert torch.equal(parts, whole), chunk
    torch.testing.assert_close(whole.cpu(), ops.client_divergence(
        plane.cpu(), g.cpu()), rtol=1e-5, atol=1e-5)


def test_paged_store_on_the_card_equals_the_dense_host_loop(cuda):
    """``store="paged"`` with 3 chunks of the plane and the exact refresh
    against the dense host loop from the same seed, on the card: the
    selections, T_k, E_k, the global row, the divergences and the client
    tree bit for bit."""
    from repro_torch.api import ExperimentSpec, build_experiment
    spec = ExperimentSpec(**dict(TINY, clients=12))
    dense = build_experiment(spec, device=cuda)
    h_d = dense._run_host(None, 3, 0.0)
    paged = build_experiment(spec.replace(store="paged", chunk_size=5,
                                          div_refresh_every=1), device=cuda)
    h_p = paged.run()
    for a, b in zip(h_d.selected, h_p.selected):
        np.testing.assert_array_equal(a, b)
    assert h_p.T_k == h_d.T_k and h_p.E_k == h_d.E_k
    assert torch.equal(paged.global_vec, dense.global_vec)
    np.testing.assert_array_equal(paged.divergences(), dense.divergences())
    want, got = dense.client_tree(), paged.client_tree()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


# ---------------------------------------------------------------------------
# the buffered-asynchronous engine
# ---------------------------------------------------------------------------


def test_async_replays_equal_eager_ticks(cuda):
    """Three replays of the captured FedBuff tick under churn against three
    eager ticks of the same round body from the same carry, batch indices
    and churn uniforms: the global row, the plane, the stats table and
    every output bit for bit."""
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.core import engine
    from repro_torch.core.graphs import eager_solves
    spec = ExperimentSpec(**TINY, aggregator="fedbuff:2:0.5",
                          churn_leave=0.3, churn_join=0.3)
    exp = build_experiment(spec, device=cuda)
    hist = exp.run(rounds=1)             # the initial round + one tick
    assert hist.seconds == [] and len(hist.participation) == 1
    inputs = exp.traced_inputs()
    prog = engine.run_rounds(
        exp.engine_cfg, selector=exp.selector, allocator=exp.allocator,
        aggregator=exp.aggregator, tctx=exp.traced_context(),
        feature_layer=exp.fl.feature_layer, device=exp.device,
        shapes=inputs.shapes(), compressor=exp.compressor,
        channel=exp.channel, churn=exp.churn)
    assert prog.graph is not None and prog.ph.churn_on
    draws = [(exp.draws.batch_indices(prog.pad, 2, 8, 16),
              torch.stack(exp.draws.churn_step(8))) for _ in range(3)]
    prog.load(exp.traced_state(), inputs)
    got = [[None if t is None else t.clone()
            for t in prog.replay(b, churn=c)] for b, c in draws]
    got_state = [t.clone() for t in (prog.state.params,
                                     prog.state.client_params,
                                     *prog.state.sched)]
    state = exp.traced_state()
    want = []
    with eager_solves():
        for b, c in draws:
            state, out = prog.round_body(state, inputs, b, churn=c)
            want.append(out)
    torch.cuda.synchronize()
    for g_out, w_out in zip(got, want):
        for name, g, w in zip(engine.RoundOutputs._fields, g_out, w_out):
            assert (g is None) == (w is None), name
            assert g is None or torch.equal(g, w), name
    for g, w in zip(got_state, (state.params, state.client_params,
                                *state.sched)):
        assert torch.equal(g, w)


def test_async_candidate_fold_matches_plain(cuda):
    """The tick's fold of its M = 4 candidates at the paper CNN's width,
    a weight-0 NaN row among them, against the plain version."""
    flat = torch.tensor(_normal(40, 4, 113_744), device=cuda)
    w = torch.tensor([0.5, 0.0, 1.0, 0.25], device=cuda)
    flat[1] = float("nan")
    before = flat_aggregate.launches
    got = ops.flat_aggregate(flat, w)
    torch.cuda.synchronize()
    assert flat_aggregate.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, flat_aggregate_plain(
        flat, w / w.sum()), **AGG_TOL)


def _robust_rows(cuda, n=10, p=113_744, dead=(3, 7)):
    g = torch.tensor(_normal(50, p) * 0.1, device=cuda)
    rows = g + torch.tensor(_normal(51, n, p) * 0.1, device=cuda)
    w = torch.tensor(np.abs(_normal(52, n)) + 0.1, device=cuda)
    for i in dead:                      # lost or guarded uploads
        rows[i] = float("nan")
        w[i] = 0.0
    return g, rows, w


def test_clipnorm_fold_through_the_kernel_matches_plain(cuda):
    """``clipnorm:c`` at a faulty round's shape: its clipped rows fold
    through the hand kernel (one launch), the NaN rows at weight 0
    skipped, against the same fold of the plain path on the CPU."""
    from repro_torch.api.registry import AGGREGATORS
    cn = AGGREGATORS.resolve("clipnorm:1.0")
    g, rows, w = _robust_rows(cuda)
    before = flat_aggregate.launches
    got, _ = cn.aggregate_flat(g, rows, w)
    torch.cuda.synchronize()
    assert flat_aggregate.launches == before + 1
    assert torch.isfinite(got).all()
    want, _ = cn.aggregate_flat(g.cpu(), rows.cpu(), w.cpu())
    torch.testing.assert_close(got.cpu(), want, **AGG_TOL)


def test_trimmed_on_the_card_matches_the_cpu(cuda):
    """``trimmed:f`` (a sort, as the reference's ``jnp.sort``) on the card
    against the CPU, zero-weight NaN lanes included."""
    from repro_torch.api.registry import AGGREGATORS
    g, rows, w = _robust_rows(cuda)
    for f in (0.0, 0.2, 0.4):
        tm = AGGREGATORS.resolve(f"trimmed:{f}")
        got, _ = tm.aggregate_flat(g, rows, w)
        want, _ = tm.aggregate_flat(g.cpu(), rows.cpu(), w.cpu())
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def test_faulty_replays_equal_eager_rounds(cuda):
    """Three replays of the captured round under faults and quarantine
    against three eager rounds of the same body from the same carry,
    batch indices and fault draws: the global row, the plane, the counts
    and every output bit for bit; a guarded run makes no host sync."""
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.core import engine
    from repro_torch.core.faults import draw_fault_masks
    from repro_torch.core.graphs import eager_solves
    spec = ExperimentSpec(**TINY, aggregator="trimmed:0.2",
                          faults="outage:0.3,corrupt:0.3,byzantine:0.3",
                          quarantine_after=1)
    exp = build_experiment(spec, device=cuda)
    exp.run(rounds=1)                    # the initial round + one replay
    res = exp.traced_run(exp.selector, 2, include_initial_round=False,
                         draws=exp.draws)
    prog = engine.run_rounds(
        exp.engine_cfg, selector=exp.selector, allocator=exp.allocator,
        aggregator=exp.aggregator, tctx=exp.traced_context(),
        feature_layer=exp.fl.feature_layer, device=exp.device,
        shapes=exp.traced_inputs().shapes(), compressor=exp.compressor,
        channel=exp.channel, churn=exp.churn, **exp._fault_args())
    assert prog.graph is not None and prog.ph.faults_on
    assert res.rounds.kept is not None
    prog(exp.traced_state(), *exp.traced_inputs(), draws=exp.draws,
         rounds=2, with_init=False, transfer_guard=True)
    inputs = exp.traced_inputs()
    draws = []
    for _ in range(3):
        b = exp.draws.batch_indices(prog.pad, 2, 8, 16)
        draws.append((b, draw_fault_masks(exp.faults, (prog.pad,),
                                          exp.draws)))
    prog.load(exp.traced_state(), inputs)
    got = [[None if t is None else t.clone()
            for t in prog.replay(b, fault=f)] for b, f in draws]
    got_state = [t.clone() for t in (prog.state.params,
                                     prog.state.client_params,
                                     prog.state.sched.faults,
                                     prog.state.sched.strikes)]
    state = exp.traced_state()
    want = []
    with eager_solves():
        for b, f in draws:
            state, out = prog.round_body(state, inputs, b, fault=f)
            want.append(out)
    torch.cuda.synchronize()
    for g_out, w_out in zip(got, want):
        for name, g, w in zip(engine.RoundOutputs._fields, g_out, w_out):
            assert (g is None) == (w is None), name
            assert g is None or torch.equal(g, w), name
    for g, w in zip(got_state, (state.params, state.client_params,
                                state.sched.faults, state.sched.strikes)):
        assert torch.equal(g, w)
    assert float(state.sched.faults.sum()) > 0


def test_selection_ranks_nan_last_on_the_card(cuda):
    """A non-finite row's divergence is a NaN whose sign bit the card sets
    (positive) and x86 does not (negative): the selectors' top-k ranks
    every NaN last, so a cohort of divergences with NaN, ±inf and signed
    zeros selects on the card what it selects on the CPU."""
    from repro_torch.strategies.traced import (_stable_top,
                                               select_divergence_traced)
    rng = np.random.default_rng(0)
    x = rng.gamma(2.0, 1.0, (3, 40)).astype(np.float32)
    x[:, [1, 7, 30]] = np.uint32(0xFFC00000).view(np.float32)   # x86 NaN
    x[:, [4, 9]] = np.inf
    x[:, [11, 12]] = (0.0, -0.0)
    on_card = torch.tensor(x, device=cuda)
    on_card[:, 30] = torch.sqrt(torch.tensor(-1.0, device=cuda))  # card NaN
    v_c, i_c = _stable_top(on_card, 25)
    v_h, i_h = _stable_top(torch.tensor(x), 25)
    assert torch.equal(i_c.cpu(), i_h)
    assert torch.equal(v_c.cpu().isnan(), v_h.isnan())
    labels = torch.tensor(rng.integers(0, 4, 40))
    got = select_divergence_traced(on_card[0], labels.to(cuda),
                                   num_clusters=4, s=2, num_devices=40)
    want = select_divergence_traced(torch.tensor(x[0]), labels,
                                    num_clusters=4, s=2, num_devices=40)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
