"""The flash-attention kernel's grid plan (``plan_attention``,
``block_key_tiles``), checked on the CPU: the kernel runs only on the card,
but the plan that cuts its work into blocks is plain Python that the
kernel mirrors. For every packed (query, q-head) row, each key tile that
holds an unmasked key of its query must be visited by exactly one
(row tile, chunk) block, and no (row, key tile) pair twice.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from repro_torch.kernels.flash_attention import (BLOCK_KEYS, BLOCK_ROWS,
                                                 SPLIT_BLOCKS, AttentionPlan,
                                                 block_key_tiles,
                                                 key_tile_range,
                                                 plan_attention)

SHAPES = [  # B, Sq, Sk, H, K, causal, window
    (8, 32, 32, 32, 4, True, None),            # the FL path (tinyllama)
    (8, 32, 32, 8, 2, True, None),             # the smoke width
    (1, 1, 2048, 32, 4, True, None),           # one query, split key tiles
    (1, 1, 2047, 32, 4, True, 512),
    (1, 3, 2048, 32, 4, True, None),
    (1, 3, 2047, 32, 4, True, 100),
    (2, 96, 40, 32, 4, True, None),            # Sq > Sk: rows with no key
    (1, 300, 300, 8, 8, True, None),           # H / K = 1
    (2, 37, 300, 16, 8, True, 64),             # H / K = 2
    (3, 29, 29, 16, 2, True, None),            # H / K = 8
    (2, 70, 130, 4, 1, False, 50),             # no causal mask
    (1, 50, 600, 8, 1, True, 128),
    (1, 2, 5000, 4, 2, False, None),
    (1, 40, 40, 4, 2, True, 0),                # window 0: every key masked
]


def _needed(sq, sk, causal, window):
    """[Sq, tiles]: whether key tile j holds an unmasked key of query i,
    from the mask itself."""
    qpos = np.arange(sq)[:, None] + (sk - sq)
    kpos = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), dtype=bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    tiles = -(-sk // BLOCK_KEYS)
    pad = np.zeros((sq, tiles * BLOCK_KEYS), dtype=bool)
    pad[:, :sk] = mask
    return pad.reshape(sq, tiles, BLOCK_KEYS).any(axis=2)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_every_unmasked_key_tile_is_visited_once(shape):
    b, sq, sk, h, k, causal, window = shape
    g = h // k
    plan = plan_attention(b, sq, sk, h, k, causal, window)
    needed = np.repeat(_needed(sq, sk, causal, window), g,
                       axis=0)                    # packed row r: query r // g
    visits = np.zeros(needed.shape, dtype=int)
    for rt in range(plan.row_tiles):
        rows = slice(rt * BLOCK_ROWS, (rt + 1) * BLOCK_ROWS)
        for chunk in range(plan.chunks):
            tiles = block_key_tiles(plan, sq, sk, g, causal, window, rt,
                                    chunk)
            assert tiles.start >= 0 and tiles.stop <= needed.shape[1]
            visits[rows, tiles.start:tiles.stop] += 1
    assert visits.max(initial=0) <= 1
    assert (visits[needed] == 1).all()
    assert plan.row_tiles * BLOCK_ROWS >= sq * g > (
        plan.row_tiles - 1) * BLOCK_ROWS


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_chunks_follow_the_shape(shape):
    """The chunk count is a function of the shape alone. The chunks cut the
    hull of all queries' key tiles (which holds every needed tile) without
    an empty chunk, at least two tiles each, and only where the (row tile,
    b, KV head) blocks are too few to fill the card."""
    b, sq, sk, h, k, causal, window = shape
    plan = plan_attention(b, sq, sk, h, k, causal, window)
    assert isinstance(plan, AttentionPlan)
    assert plan == plan_attention(b, sq, sk, h, k, causal, window)
    lo, hi = key_tile_range(sk - sq, sk - 1, sk, causal, window)
    n = hi - lo + 1
    needed = np.flatnonzero(_needed(sq, sk, causal, window).any(axis=0))
    assert ((needed >= lo) & (needed <= hi)).all()
    if n > 0:
        assert plan.first_tile == lo
        assert (plan.chunks - 1) * plan.tiles_per_chunk < n \
            <= plan.chunks * plan.tiles_per_chunk
    else:
        assert plan.chunks == 1
    base = b * k * plan.row_tiles
    assert (plan.chunks > 1) == (base < SPLIT_BLOCKS and n >= 4)
    assert plan.chunks <= SPLIT_BLOCKS
    assert plan.chunks == 1 or plan.tiles_per_chunk >= 2


def test_plans_at_the_main_shapes():
    fl = plan_attention(8, 32, 32, 32, 4)            # 128 full row tiles
    assert (fl.row_tiles, fl.chunks) == (4, 1)
    one = plan_attention(1, 1, 2048, 32, 4)          # 8 packed rows
    assert (one.row_tiles, one.chunks, one.tiles_per_chunk) == (1, 32, 2)
    assert plan_attention(2, 96, 40, 32, 4).chunks == 1       # 2 key tiles
    wide = plan_attention(1, 2048, 2048, 32, 4)
    assert (wide.row_tiles, wide.chunks) == (256, 1)
    few = plan_attention(1, 1, 100_000, 4, 1)        # chunks capped
    assert few.chunks <= SPLIT_BLOCKS
    assert few.chunks * few.tiles_per_chunk >= -(-100_000 // 32)
