"""The flash-attention kernel's grid plan (``plan_attention``,
``block_key_tiles``), checked on the CPU: the kernel runs only on the card,
but the plan that cuts its work into blocks is plain Python that the
kernel mirrors. For every packed (query, q-head) row, each key tile that
holds an unmasked key of its query must be visited by exactly one
(row tile, chunk) block, and no (row, key tile) pair twice. The bf16
kernel tiles the keys 64 at a time and its rows 128 at a time at head dim
64 or less (64 above), the fp32 one 32 keys and 64 rows at a time
(``block_shape``): each plan is checked at its own sizes, and the
``meta`` launch of the dry run holds the split-KV scratch of the plan of
its dtype.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro_torch.kernels.build import kernel_allocations
from repro_torch.kernels.flash_attention import (BLOCK_KEYS, BLOCK_KEYS_BF16,
                                                 BLOCK_ROWS, BLOCK_ROWS_BF16,
                                                 SPLIT_BLOCKS, AttentionPlan,
                                                 block_key_tiles, block_shape,
                                                 flash_attention,
                                                 key_tile_range,
                                                 plan_attention)
from repro_torch.roofline.analysis import peak_memory

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


def _needed(sq, sk, causal, window, keys=BLOCK_KEYS):
    """[Sq, tiles]: whether key tile j (of ``keys`` keys) holds an
    unmasked key of query i, from the mask itself."""
    qpos = np.arange(sq)[:, None] + (sk - sq)
    kpos = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), dtype=bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    tiles = -(-sk // keys)
    pad = np.zeros((sq, tiles * keys), dtype=bool)
    pad[:, :sk] = mask
    return pad.reshape(sq, tiles, keys).any(axis=2)


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


# ---------------------------------------------------------------------------
# the bf16 kernel's plan: 64-key tiles, 128 rows a block at D <= 64
# ---------------------------------------------------------------------------

BF16_SHAPES = SHAPES + [
    (2, 4096, 4096, 32, 4, True, None),        # 17(b)'s train, batch cut
    (1, 65, 4097, 8, 8, True, 1000),           # a ragged last key tile
]
BF16_BLOCKS = [block_shape(torch.bfloat16, d) for d in (64, 128)]
BF16_CASES = [(shape, blk) for blk in BF16_BLOCKS for shape in BF16_SHAPES]
BF16_IDS = [f"{shape}-{blk}" for shape, blk in BF16_CASES]


def test_block_shape_follows_dtype_and_head_dim():
    for d in (16, 32, 64, 96, 128):
        assert block_shape(torch.float32, d) == (BLOCK_ROWS, BLOCK_KEYS) \
            == (64, 32)
    for d in (16, 32, 64):
        assert block_shape(torch.bfloat16, d) == (BLOCK_ROWS_BF16,
                                                  BLOCK_KEYS_BF16) == (128, 64)
    for d in (96, 128):
        assert block_shape(torch.bfloat16, d) == (64, 64)


@pytest.mark.parametrize("shape,blk", BF16_CASES, ids=BF16_IDS)
def test_bf16_every_unmasked_key_tile_is_visited_once(shape, blk):
    b, sq, sk, h, k, causal, window = shape
    g, (rows, keys) = h // k, blk
    plan = plan_attention(b, sq, sk, h, k, causal, window, keys, rows)
    needed = np.repeat(_needed(sq, sk, causal, window, keys), g, axis=0)
    visits = np.zeros(needed.shape, dtype=np.int8)
    for rt in range(plan.row_tiles):
        for chunk in range(plan.chunks):
            tiles = block_key_tiles(plan, sq, sk, g, causal, window, rt,
                                    chunk, keys, rows)
            assert tiles.start >= 0 and tiles.stop <= needed.shape[1]
            visits[rt * rows:(rt + 1) * rows, tiles.start:tiles.stop] += 1
    assert visits.max(initial=0) <= 1
    assert (visits[needed] == 1).all()
    assert plan.row_tiles * rows >= sq * g > (plan.row_tiles - 1) * rows


@pytest.mark.parametrize("shape,blk", BF16_CASES, ids=BF16_IDS)
def test_bf16_chunks_follow_the_shape(shape, blk):
    """As ``test_chunks_follow_the_shape``, on 64-key tiles: half as many
    tiles, so a split plan has about half the chunks of the fp32 one."""
    b, sq, sk, h, k, causal, window = shape
    rows, keys = blk
    plan = plan_attention(b, sq, sk, h, k, causal, window, keys, rows)
    assert plan == plan_attention(b, sq, sk, h, k, causal, window, keys,
                                  rows)
    lo, hi = key_tile_range(sk - sq, sk - 1, sk, causal, window, keys)
    n = hi - lo + 1
    needed = np.flatnonzero(_needed(sq, sk, causal, window, keys).any(axis=0))
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


def test_bf16_plans_at_the_main_shapes():
    rows, keys = block_shape(torch.bfloat16, 64)
    fl = plan_attention(8, 32, 32, 32, 4, keys=keys, rows=rows)
    assert fl == AttentionPlan(2, 1, 1, 0)
    one = plan_attention(1, 1, 2048, 32, 4, keys=keys, rows=rows)
    assert (one.row_tiles, one.chunks, one.tiles_per_chunk) == (1, 16, 2)
    train = plan_attention(4, 4096, 4096, 32, 4, keys=keys, rows=rows)
    assert train == AttentionPlan(256, 1, 64, 0)            # 17(b)
    prefill = plan_attention(1, 32768, 32768, 32, 4, keys=keys, rows=rows)
    assert prefill == AttentionPlan(2048, 1, 512, 0)
    # the prefill's last row tile (queries 32752-32767) reads every key
    # tile, its first (queries 0-15) only the first
    assert block_key_tiles(prefill, 32768, 32768, 8, True, None, 2047, 0,
                           keys, rows) == range(0, 512)
    assert block_key_tiles(prefill, 32768, 32768, 8, True, None, 0, 0,
                           keys, rows) == range(0, 1)
    rows96, keys96 = block_shape(torch.bfloat16, 96)     # phi-3-vision
    phi3 = plan_attention(4, 128, 128, 32, 32, keys=keys96, rows=rows96)
    assert phi3 == AttentionPlan(2, 1, 2, 0)
    few = plan_attention(1, 1, 100_000, 4, 1, keys=keys, rows=rows)
    assert few.chunks <= SPLIT_BLOCKS
    assert few.chunks * few.tiles_per_chunk >= -(-100_000 // keys)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_meta_launch_holds_the_split_scratch_of_its_plan(dtype):
    """The dry run's ``meta`` launch (``kernel_allocations``) holds the
    output and, for a split plan, its fp32 partials: ``chunks`` of them at
    the plan of its dtype's block (32 chunks of 32 keys in fp32, 16 of 64
    in bf16, for one query over 2048 keys)."""
    meta = torch.device("meta")
    q = torch.empty((1, 1, 32, 64), dtype=dtype, device=meta)
    k = torch.empty((1, 2048, 4, 64), dtype=dtype, device=meta)
    rows, keys = block_shape(dtype, 64)
    chunks = plan_attention(1, 1, 2048, 32, 4, keys=keys, rows=rows).chunks
    assert chunks == {torch.float32: 32, torch.bfloat16: 16}[dtype]
    with kernel_allocations():
        peak = peak_memory(lambda q, k: flash_attention(q, k, k), q, k)
    held = q.nbytes + k.nbytes
    out = q.nbytes
    scratch = chunks * (32 * 64 + 32 * 2) * 4
    assert peak == held + out + scratch
