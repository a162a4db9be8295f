"""The port's client store (``repro_torch.core.store``) against the
reference's (``repro.core.store``): the same scatter / stage sequence on
both sides must leave the same rows, blocks, overlay, touched mask and
byte counts, bit for bit; then the store's own contract — promotion,
``assemble`` over mixed ranges, ``iter_chunks``, the staging LRU,
``nbytes`` — and the stats table."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import store as ref_store

from repro_torch.core.store import (ClientStats, DenseStore, PagedStore,
                                    build_store)

N, P, CHUNK = 10, 7, 4
# (idx, seed of the rows): overlay rows, a promotion of chunk 0, a write
# into a promoted block, rewrites, the short last chunk
SCATTERS = [([9, 0, 5], 1), ([1], 2), ([2, 9], 3), ([8], 4), ([5, 6], 5)]


def _rows(idx, seed):
    return np.random.default_rng(seed).standard_normal(
        (len(idx), P)).astype(np.float32)


def _pair(stage_rows=None):
    base = np.random.default_rng(0).standard_normal(P).astype(np.float32)
    return (ref_store.PagedStore(base, N, CHUNK, stage_rows=stage_rows),
            PagedStore(base, N, CHUNK, stage_rows=stage_rows))


def _same_state(ref, port):
    assert sorted(ref._blocks) == sorted(port._blocks)
    for cid in ref._blocks:
        np.testing.assert_array_equal(port._blocks[cid], ref._blocks[cid])
    assert sorted(ref._rows) == sorted(port._rows)
    for i in ref._rows:
        np.testing.assert_array_equal(port._rows[i], ref._rows[i])
    np.testing.assert_array_equal(port.touched, ref.touched)
    assert port.num_touched == ref.num_touched
    assert port.nbytes == ref.nbytes
    for i in range(N):
        np.testing.assert_array_equal(port.row(i), ref.row(i))


@pytest.mark.parametrize("step", range(len(SCATTERS)))
def test_paged_store_equals_the_reference_after_each_scatter(step):
    ref, port = _pair()
    for idx, seed in SCATTERS[:step + 1]:
        rows = _rows(idx, seed)
        ref.scatter(np.asarray(idx), jnp.asarray(rows))
        port.scatter(np.asarray(idx), torch.tensor(rows))
    _same_state(ref, port)
    gather = [3, 0, 9, 5, 5]
    np.testing.assert_array_equal(port.gather(gather).numpy(),
                                  np.asarray(ref.gather(gather)))
    for start, stop in ((0, 10), (2, 7), (4, 8), (9, 10), (3, 4)):
        np.testing.assert_array_equal(port.assemble(start, stop),
                                      ref.assemble(start, stop))
    for c in (3, 4, 10):
        for a, b in zip(port.iter_chunks(c), ref.iter_chunks(c)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_staging_equals_the_reference():
    ref, port = _pair(stage_rows=2)
    for idx, seed in ((np.array([1, 6]), 7), (np.array([6, 3]), 8)):
        rows = _rows(idx, seed)
        ref.stage(idx, jnp.asarray(rows))
        port.stage(idx, torch.tensor(rows))
        assert list(port._staged) == list(ref._staged)
    _same_state(ref, port)
    for idx in ([6, 3], [1, 3], [0]):       # all staged, mixed, cold
        np.testing.assert_array_equal(port.gather_staged(idx).numpy(),
                                      np.asarray(ref.gather_staged(idx)))
    ref.release_staged([6])
    port.release_staged([6])
    assert list(port._staged) == list(ref._staged) == [3]


def test_staged_rows_survive_the_callers_block():
    _, port = _pair(stage_rows=4)
    rows = torch.tensor(_rows([2, 4], 9))
    port.stage([2, 4], rows)
    want = rows.clone()
    rows.zero_()                         # the caller reuses its block
    torch.testing.assert_close(port.gather_staged([2, 4]), want,
                               rtol=0, atol=0)


def test_promotion_to_a_dense_block():
    store = PagedStore(np.zeros(4, np.float32), 8, chunk_size=4)
    store.scatter(np.array([0]), np.ones((1, 4), np.float32))
    assert not store._blocks and list(store._rows) == [0]   # 1/4 < 1/2
    store.scatter(np.array([1]), 2 * np.ones((1, 4), np.float32))
    assert list(store._blocks) == [0] and not store._rows   # 2/4 = 1/2
    store.scatter(np.array([2]), 3 * np.ones((1, 4), np.float32))
    assert not store._rows                  # written into the block
    np.testing.assert_array_equal(store.row(2), 3 * np.ones(4))
    np.testing.assert_array_equal(store.row(3), np.zeros(4))
    assert store.num_touched == 3
    # the block's own range is the block itself, not a copy
    assert store.assemble(0, 4) is store._blocks[0]
    assert store.assemble(0, 3) is not store._blocks[0]


def test_assemble_and_iter_chunks_cover_the_plane():
    base = np.arange(3, dtype=np.float32)
    store = PagedStore(base, 7, chunk_size=3)
    store.scatter(np.array([0, 1, 5]), np.full((3, 3), 9.0, np.float32))
    want = np.tile(base, (7, 1))
    want[[0, 1, 5]] = 9.0
    for c in (1, 2, 3, 7, 100):
        got = np.concatenate(list(store.iter_chunks(c)))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(store.assemble(4, 100), want[4:])
    assert [b.shape[0] for b in store.iter_chunks()] == [3, 3, 1]


def test_nbytes_counts_base_overlay_blocks_and_mask():
    store = PagedStore(np.zeros(5, np.float32), 8, chunk_size=4)
    assert store.nbytes == 5 * 4 + 8
    store.scatter(np.array([7]), np.ones((1, 5), np.float32))
    assert store.nbytes == 5 * 4 + 5 * 4 + 8            # one overlay row
    store.scatter(np.array([0, 1]), np.ones((2, 5), np.float32))
    assert store.nbytes == 5 * 4 + 5 * 4 + 4 * 5 * 4 + 8   # + a block


def test_scatter_checks_its_rows():
    store = PagedStore(np.zeros(3, np.float32), 4, chunk_size=2)
    with pytest.raises(ValueError, match="do not match"):
        store.scatter(np.array([0, 1]), np.ones((3, 3), np.float32))
    with pytest.raises(ValueError, match="positive"):
        PagedStore(np.zeros(3, np.float32), 4, chunk_size=0)


def test_dense_store_wraps_the_plane_in_place():
    plane = torch.zeros((6, 3))
    store = DenseStore(plane)
    assert store.buffer is plane
    rows = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    store.scatter([4, 1], rows)
    torch.testing.assert_close(plane[[4, 1]], rows, rtol=0, atol=0)
    torch.testing.assert_close(store.gather([1, 4]), rows[[1, 0]],
                               rtol=0, atol=0)
    chunks = list(store.iter_chunks(4))
    assert [c.shape for c in chunks] == [(4, 3), (2, 3)]
    chunks[0][:] = -1.0                  # a copy: the plane is untouched
    assert float(plane.min()) == 0.0
    store.stage([0], rows[:1])
    torch.testing.assert_close(store.gather_staged([0]), rows[:1],
                               rtol=0, atol=0)
    assert store.nbytes == 6 * 3 * 4 and store.num_clients == 6
    assert store.row_size == 3


def test_dense_store_equals_the_reference():
    class _Engine:                       # the reference's donated scatter
        @staticmethod
        def scatter_rows(buf, idx, rows):
            return buf.at[idx].set(rows)

    base = np.random.default_rng(3).standard_normal(P).astype(np.float32)
    ref = ref_store.DenseStore(jnp.asarray(base), N, _Engine())
    port = build_store("dense", torch.tensor(base), N, CHUNK)
    for idx, seed in SCATTERS:
        rows = _rows(idx, seed)
        ref.scatter(np.asarray(idx), jnp.asarray(rows))
        port.scatter(np.asarray(idx), torch.tensor(rows))
    np.testing.assert_array_equal(port.buffer.numpy(), np.asarray(ref.buffer))
    for a, b in zip(port.iter_chunks(3), ref.iter_chunks(3)):
        np.testing.assert_array_equal(a, b)
    assert port.nbytes == ref.nbytes and port.kind == ref.kind


def test_build_store_kinds():
    base = torch.arange(4, dtype=torch.float32)
    paged = build_store("paged", base, 9, 2, stage_rows=3)
    assert paged.kind == "paged" and paged.stage_rows == 3
    base += 1.0                          # the global row moves on
    np.testing.assert_array_equal(paged.base, np.arange(4))
    assert paged.num_clients == 9 and paged.row_size == 4
    with pytest.raises(ValueError, match="unknown client store"):
        build_store("sharded", base, 9, 2)


def test_stats_table_equals_the_reference():
    port, ref = ClientStats.create(6, cell=2), ref_store.ClientStats.create(
        6, cell=2)
    assert port._fields == ref._fields
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert port.nbytes == ref.nbytes


def test_stats_device_copy_and_load_in_place():
    st = ClientStats.create(5)
    dev = st.device("cpu")
    assert all(isinstance(c, torch.Tensor) for c in dev)
    assert dev.avail.dtype == torch.bool and dev.cell.dtype == torch.int32
    dev.age.add_(3.0)                     # a copy: the table is untouched
    assert float(st.age.max()) == 0.0
    dev.avail[1] = False
    columns = [id(c) for c in st]
    st.load(dev)
    assert [id(c) for c in st] == columns             # no column rebound
    np.testing.assert_array_equal(st.age, np.full(5, 3.0, np.float32))
    assert not st.avail[1] and st.avail.sum() == 4
    assert dev.nbytes == st.nbytes
    traced = ClientStats.create_traced(4, cell=1)
    assert traced.cell.tolist() == [1] * 4
    assert torch.isinf(traced.t_done).all()
