"""The chunked SSD form and the grid plans of the redesigned kernels,
checked on the CPU.

- ``kernels.ssd_chunked.ssd_chunked`` (re-exported as
  ``models.layers.ssd_chunked``) against the reference's ``ssd_chunked``
  (ragged S, chunk > S, groups, N = 24, a carried initial state), within
  1e-4 (fp32, the reference's own SSD bound).
- ``kernels.ssd_scan.ssd_scan_grads`` — what ``_SsdScan.backward`` returns,
  autograd through the chunked form — against ``jax.grad`` of the
  reference's ``ssd_chunked`` and against autograd through the plain
  token-by-token recurrence, within 1e-4.
- ``plan_ssd``, which the kernel takes as its grid: under the kernel's
  block decode (``ssd_chunk_kernel``, transcribed here) every (b·h, chunk,
  row tile, P tile) of y and every (b·h, chunk, P tile, N tile) of the
  state is one block, once; one launch for one chunk, three otherwise;
  the shared memory it asks for fits a block. The kernel refuses a plan
  that does not match its own (``test_torch_cuda.py``).
- ``plan_slabs`` of ``pairwise_l2``: every column of F lies in exactly one
  slab, and the plan is a function of the shapes alone.
- ``kernels.build.library_path`` keys a library on the shared headers.

The kernels themselves run only on the card (``test_torch_cuda.py``);
inputs here are numpy draws from a seed.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers

from repro_torch.kernels import build
from repro_torch.kernels.pairwise_l2 import MIN_SLAB, TARGET_BLOCKS, plan_slabs
from repro_torch.kernels.ssd_chunked import ssd_chunked
from repro_torch.kernels.ssd_scan import (BLOCK_N, BLOCK_P, BLOCK_ROWS,
                                          plan_ssd, smem_bytes,
                                          ssd_scan_grads, ssd_scan_plain)
from repro_torch.models import layers

SSD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _ssd_inputs(seed, b, s, h, g, p, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    a = -rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32)
    bm = (rng.normal(size=(b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    cm = (rng.normal(size=(b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    return x, a, bm, cm


CHUNKED = [  # b, s, h, g, p, n, chunk, initial state
    (2, 32, 4, 1, 8, 16, 8, False),            # S a multiple of the chunk
    (1, 45, 4, 2, 8, 16, 16, False),           # ragged S, two groups
    (2, 20, 4, 1, 8, 16, 64, False),           # chunk > S: one padded chunk
    (1, 37, 6, 3, 16, 24, 8, False),           # N = 24, three groups
    (2, 29, 4, 2, 8, 16, 8, True),             # a carried initial state
]


@pytest.mark.parametrize("b,s,h,g,p,n,chunk,init", CHUNKED,
                         ids=[str(c) for c in CHUNKED])
def test_ssd_chunked_matches_the_reference(b, s, h, g, p, n, chunk, init):
    x, a, bm, cm = _ssd_inputs(100 + s, b, s, h, g, p, n)
    h0 = (np.random.default_rng(s).normal(size=(b, h, p, n)).astype(np.float32)
          if init else None)
    y, state = layers.ssd_chunked(
        *(torch.tensor(t) for t in (x, a, bm, cm)), chunk,
        None if h0 is None else torch.tensor(h0))
    y_r, state_r = jlayers.ssd_chunked(x, a, bm, cm, chunk, h0)
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **SSD_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(state_r), **SSD_TOL)


def test_ssd_chunked_without_initial_state_is_the_recurrence():
    x, a, bm, cm = _ssd_inputs(3, 2, 50, 4, 2, 8, 16)
    args = [torch.tensor(t) for t in (x, a, bm, cm)]
    for got, want in zip(layers.ssd_chunked(*args, 16),
                         ssd_scan_plain(*args)):
        torch.testing.assert_close(got, want, **SSD_TOL)


GRADS = [  # b, s, h, g, p, n, chunk (the kernel's Q is min(chunk, S))
    (2, 20, 4, 1, 8, 16, 8),                   # ragged last chunk
    (1, 32, 4, 2, 8, 24, 16),                  # groups, N = 24, exact chunks
    (2, 12, 2, 1, 8, 16, 256),                 # chunk > S: one chunk
]


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", GRADS,
                         ids=[str(c) for c in GRADS])
def test_chunked_backward_matches_jax_and_the_recurrence(b, s, h, g, p, n,
                                                         chunk):
    """``_SsdScan.backward``'s gradients, called directly: cotangents on
    both y and the final state."""
    x, a, bm, cm = _ssd_inputs(7 + s, b, s, h, g, p, n)
    rng = np.random.default_rng(s + n)
    wy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    ws = rng.normal(size=(b, h, p, n)).astype(np.float32)
    q = min(chunk, s)

    def jloss(x, a, bm, cm):
        y, st = jlayers.ssd_chunked(x, a, bm, cm, q)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(x, a, bm, cm)
    args = [torch.tensor(t) for t in (x, a, bm, cm)]
    got = ssd_scan_grads(*args, chunk, torch.tensor(wy), torch.tensor(ws),
                         (True,) * 4)
    leaves = [t.clone().requires_grad_(True) for t in args]
    y, st = ssd_scan_plain(*leaves)
    plain = torch.autograd.grad([y, st], leaves,
                                [torch.tensor(wy), torch.tensor(ws)])
    for g1, wg, g2 in zip(got, want, plain):
        np.testing.assert_allclose(g1.numpy(), np.asarray(wg), **GRAD_TOL)
        torch.testing.assert_close(g1, g2, **GRAD_TOL)


def test_chunked_backward_keeps_none_cotangents_and_unneeded_inputs():
    x, a, bm, cm = _ssd_inputs(21, 1, 24, 2, 1, 8, 16)
    args = [torch.tensor(t) for t in (x, a, bm, cm)]
    wy = torch.tensor(np.random.default_rng(22).normal(
        size=(1, 24, 2, 8)).astype(np.float32))
    got = ssd_scan_grads(*args, 16, wy, None, (True, False, True, False))
    assert got[1] is None and got[3] is None
    leaves = [t.clone().requires_grad_(True) for t in args]
    want = torch.autograd.grad(ssd_scan_plain(*leaves)[0], [leaves[0],
                                                            leaves[2]], wy)
    torch.testing.assert_close(got[0], want[0], **GRAD_TOL)
    torch.testing.assert_close(got[2], want[1], **GRAD_TOL)


def test_layers_reexports_the_chunked_form():
    assert layers.ssd_chunked is ssd_chunked


def y_block_tile(plan, bh_count, idx):
    """(b·h, chunk, row tile, P tile) of y block ``idx``, as
    ``ssd_chunk_kernel`` decodes it: row tiles from the last (the most key
    tiles) to the first; within one, chunk-major, then b·h, then the P
    tile. The last chunk has only ``last_row_tiles``."""
    x = idx
    for rt in reversed(range(plan.row_tiles)):
        nch = plan.chunks - 1 + (1 if rt < plan.last_row_tiles else 0)
        cnt = nch * bh_count * plan.p_tiles
        if x < cnt:
            break
        x -= cnt
    pt = x % plan.p_tiles
    x //= plan.p_tiles
    return x % bh_count, x // bh_count, rt, pt


def state_block_tile(plan, bh_count, idx):
    """(b·h, chunk, P tile, N tile) of state block ``idx``, as
    ``ssd_chunk_kernel`` decodes it."""
    nt = idx % plan.n_tiles
    x = idx // plan.n_tiles
    pt = x % plan.p_tiles
    x //= plan.p_tiles
    return x % bh_count, x // bh_count, pt, nt


PLANS = [  # B, S, H, P, N, chunk
    (8, 32, 24, 64, 128, 256),                 # the FL path (mamba2-130m)
    (2, 32, 8, 32, 16, 32),                    # the smoke width
    (1, 2048, 24, 64, 128, 256),               # long: 8 full chunks
    (1, 300, 24, 64, 128, 256),                # ragged: 256 + 44
    (2, 77, 4, 8, 24, 16),                     # groups, ragged, N = 24
    (1, 512, 2, 64, 128, 128),                 # an exact multiple of Q
    (1, 200, 3, 136, 200, 100),                # P > 64, N > 64: more tiles
    (3, 5, 2, 8, 4, 64),                       # tiny: one short chunk
]


@pytest.mark.parametrize("shape", PLANS, ids=[str(s) for s in PLANS])
def test_ssd_plan_covers_every_tile_once(shape):
    B, S, H, P, N, chunk = shape
    plan = plan_ssd(B, S, H, P, N, chunk)
    bh = B * H
    q = min(chunk, S)
    assert plan.q == q and plan.chunks == -(-S // q)
    assert plan.last == S - (plan.chunks - 1) * q and 0 < plan.last <= q
    lens = [min(q, S - c * q) for c in range(plan.chunks)]
    want_y = {(i, c, rt, pt) for i in range(bh)
              for c, ql in enumerate(lens)
              for rt in range(-(-ql // BLOCK_ROWS))
              for pt in range(-(-P // BLOCK_P))}
    got_y = [y_block_tile(plan, bh, k) for k in range(plan.y_blocks)]
    assert len(got_y) == len(set(got_y)) and set(got_y) == want_y
    # heaviest row tiles first
    rts = [t[2] for t in got_y]
    assert rts == sorted(rts, reverse=True)
    nk = -(-N // 8) * 8
    want_s = {(i, c, pt, nt) for i in range(bh) for c in range(plan.chunks)
              for pt in range(-(-P // BLOCK_P))
              for nt in range(-(-nk // BLOCK_N))}
    got_s = [state_block_tile(plan, bh, k) for k in range(plan.state_blocks)]
    assert len(got_s) == len(set(got_s)) and set(got_s) == want_s
    assert plan.launches == (1 if plan.chunks == 1 else 3)
    assert (plan.y_smem, plan.state_smem) == smem_bytes(q, N, plan.chunks)
    assert max(plan.y_smem, plan.state_smem) <= 232_448


def test_ssd_plan_fl_and_long_shapes():
    """The FL path's call is one chunk and one launch; the published chunk
    over 2048 steps is three launches over 8 chunks."""
    fl = plan_ssd(8, 32, 24, 64, 128, 256)
    assert (fl.q, fl.chunks, fl.launches) == (32, 1, 1)
    assert (fl.y_blocks, fl.state_blocks) == (192, 384)
    long = plan_ssd(1, 2048, 24, 64, 128, 256)
    assert (long.chunks, long.launches, long.y_blocks) == (8, 3, 768)


@pytest.mark.parametrize("q,n,chunks", [(32, 128, 1), (256, 128, 8),
                                        (256, 256, 2), (16, 24, 5),
                                        (32, 128, 3)])
def test_ssd_smem_fits_a_block(q, n, chunks):
    y, state = smem_bytes(q, n, chunks)
    assert 0 < min(y, state) and max(y, state) <= 232_448
    assert y % 16 == 0 and state % 16 == 0     # 16-byte aligned tiles


def test_ssd_smem_of_the_fl_call_fits_five_blocks_an_sm():
    """A short chunk takes one stage and a C tile of its own rows: the FL
    call's 576 blocks fit the card's SMs at once (5 of 128 threads an SM
    by shared memory)."""
    y, state = smem_bytes(32, 128, 1)
    assert 5 * max(y, state) <= 232_448
    assert smem_bytes(32, 128, 3)[0] > y        # h_in needs room


SLABS = [  # n, m, f
    (40, 10, 2240),                            # K-means, CNN: pairs enough
    (40, 1, 113_744),                          # the CNN divergence
    (10, 1, 563_200),                          # the tinyllama divergence
    (10, 4, 22_528),                           # tinyllama K-means
    (4, 1, 616_704),                           # the mamba2 divergence
    (7, 3, 33),                                # f % 4 != 0
    (1, 1, 8),
    (3, 1, 5000),
    (1, 1, 0),                                 # no features
]


@pytest.mark.parametrize("n,m,f", SLABS, ids=[str(s) for s in SLABS])
def test_pairwise_slabs_cover_f_once(n, m, f):
    slabs, width = plan_slabs(n, m, f)
    assert slabs >= 1 and width >= 4 and width % 4 == 0
    cover = np.zeros(max(f, 1), dtype=int)
    for s in range(slabs):
        lo, hi = s * width, min(f, (s + 1) * width)
        assert lo < hi or f == 0               # no empty slab
        cover[lo:hi] += 1
    assert (cover[:f] == 1).all()
    if n * m >= TARGET_BLOCKS:
        assert slabs == 1
    else:
        assert n * m * slabs <= TARGET_BLOCKS + n * m
        assert slabs == 1 or width >= MIN_SLAB
    assert plan_slabs(n, m, f) == (slabs, width)   # the shapes alone


def test_pairwise_slabs_split_the_divergence():
    assert plan_slabs(40, 10, 2240)[0] == 1    # already 400 blocks
    for n, f in ((40, 113_744), (10, 563_200), (4, 616_704)):
        slabs, _ = plan_slabs(n, 1, f)
        assert n * slabs >= TARGET_BLOCKS // 2


@pytest.mark.parametrize("target", [264, 528, 1056])
def test_pairwise_slabs_follow_the_target(target):
    """Any block target (``chip_smoke.py`` sweeps these) gives a plan that
    covers F once, within the target, and the default is the module's."""
    for n, m, f in SLABS:
        slabs, width = plan_slabs(n, m, f, target)
        assert (slabs - 1) * width < max(f, 1) <= slabs * width
        assert slabs == 1 or (n * m * slabs <= target + n * m
                              and width >= MIN_SLAB)
        assert plan_slabs(n, m, f) == plan_slabs(n, m, f, TARGET_BLOCKS)


def test_library_path_keys_on_the_shared_headers(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("k")
    assert build.library_path("k") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build.library_path("k") != before
    (tmp_path / "h.cuh").write_text("// one\n")
    assert build.library_path("k") == before
