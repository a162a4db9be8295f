"""The client parameter store — the dense device plane or the paged
active/cold split — behind one ``ClientStore`` contract, and the
per-client statistics table (``repro.core.store``).

The paper's regime is N ≫ K: many devices, of which K train a round. The
dense ``[N, P]`` plane is O(N·P) whatever K is: at the paper CNN's
P = 113,744 it is 455 MB at N = 1,000 and 455 GB at N = 1,000,000, past
any one card. So the store splits:

``DenseStore``
    The experiment's ``[N, P]`` plane on the device, wrapped as it is
    (never copied), rows written in place. The default (``store="dense"``).

``PagedStore``
    A cold store in host memory. Every client starts equal to the
    broadcast ``base`` row (one ``[P]`` vector, the initial global), so the
    store begins O(P) at any N. Trained rows land in a sparse overlay
    (``{client: [P] row}``); once half of a ``chunk_size``-aligned block has
    been written, the overlay's rows of it move into one dense ``[chunk,
    P]`` block. Reads assemble any range on demand (``iter_chunks``), so
    the plane never exists whole: memory is O(#touched·P + chunk·P). The
    device sees only the K rows of a round (the active plane): ``gather``
    assembles them into one pinned host buffer and copies it in one
    ``non_blocking`` copy; ``scatter`` copies the trained rows back once.

``ClientStats``
    The ``[N]`` table (divergence, its staleness bound, age, in-flight
    completion time, availability, cell, fault counts and the scheduler's
    clock): the only O(N) state a driver keeps hot. Selectors read it in
    place of reducing the ``[N, P]`` plane. Host numpy columns, mutated in
    place (``stats.avail[gone] = False``); ``device()`` gives a copy with
    tensor columns and ``load()`` copies one back in place.

Both stores take ``gather(idx)`` (``[K, P]`` rows on the device),
``scatter(idx, rows)``, ``iter_chunks(chunk_size)`` (host blocks), the
staging API (``stage`` / ``gather_staged`` / ``release_staged``: rows kept
on the device between a dispatch and the fold that reads them) and
``nbytes``; ``stats`` is the one source of per-client truth.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, NamedTuple, Optional, Protocol

import numpy as np
import torch

__all__ = ["ClientStats", "ClientStore", "DenseStore", "PagedStore",
           "build_store"]

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.int32): torch.int32,
                np.dtype(bool): torch.bool}


class ClientStats(NamedTuple):
    """Per-client scalars — O(N) in all, one table for every driver.

    ``divergence`` is ‖w_n − w_g‖ as of the client's last refresh;
    ``drift`` bounds its staleness: the sum of ‖g_now − g_ref‖ since that
    refresh, so the true divergence lies within ``divergence ± drift``
    (triangle inequality). ``age`` counts rounds since the client last
    contributed; ``t_done`` is the virtual completion time of an in-flight
    update (+inf when idle); ``avail`` is the churn mask selection
    filters on; ``cell`` the serving cell; ``faults`` and ``strikes``
    count fault events and non-finite payloads; ``t_now`` is the
    scheduler's virtual clock (0-d).
    """
    divergence: np.ndarray            # [N] f32  ‖w_n − w_g‖ at last refresh
    drift: np.ndarray                 # [N] f32  staleness bound on divergence
    age: np.ndarray                   # [N] f32  rounds since contribution
    t_done: np.ndarray                # [N] f32  in-flight completion (+inf idle)
    avail: np.ndarray                 # [N] bool churn/availability mask
    cell: np.ndarray                  # [N] i32  serving cell id
    faults: np.ndarray                # [N] f32  fault events charged
    strikes: np.ndarray               # [N] f32  non-finite payloads caught
    t_now: np.ndarray                 # []  f32  scheduler virtual clock

    @classmethod
    def create(cls, num_clients: int, cell: int = 0) -> "ClientStats":
        return cls(divergence=np.zeros(num_clients, np.float32),
                   drift=np.zeros(num_clients, np.float32),
                   age=np.zeros(num_clients, np.float32),
                   t_done=np.full(num_clients, np.inf, np.float32),
                   avail=np.ones(num_clients, bool),
                   cell=np.full(num_clients, cell, np.int32),
                   faults=np.zeros(num_clients, np.float32),
                   strikes=np.zeros(num_clients, np.float32),
                   t_now=np.zeros((), np.float32))

    @classmethod
    def create_traced(cls, num_clients: int, cell: int = 0,
                      device="cpu") -> "ClientStats":
        """The same fresh table with tensor columns on ``device``."""
        return cls.create(num_clients, cell).device(device)

    def device(self, device="cpu") -> "ClientStats":
        """A copy with tensor columns on ``device`` (same dtypes)."""
        return ClientStats(*(torch.tensor(
            np.asarray(c), dtype=_TORCH_DTYPE[np.asarray(c).dtype],
            device=device) for c in self))

    def load(self, other: "ClientStats") -> None:
        """Copy ``other``'s columns (numpy or tensors) into this table IN
        PLACE: no column is rebound."""
        for dst, src in zip(self, other):
            if isinstance(src, torch.Tensor):
                src = src.detach().cpu().numpy()
            np.copyto(dst, np.asarray(src))

    @property
    def nbytes(self) -> int:
        return int(sum(c.numel() * c.element_size()
                       if isinstance(c, torch.Tensor) else np.asarray(c).nbytes
                       for c in self))


class ClientStore(Protocol):
    """What every driver consumes. ``stats`` is the single source of
    per-client truth."""

    kind: str
    stats: ClientStats

    @property
    def num_clients(self) -> int: ...

    @property
    def row_size(self) -> int: ...

    def gather(self, idx) -> torch.Tensor:
        """``[K, P]`` device rows for ``idx`` — the active plane."""
        ...

    def scatter(self, idx, rows) -> None:
        """Persist trained rows."""
        ...

    def iter_chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        """Stream the (virtual) plane as host blocks."""
        ...

    def stage(self, idx, rows) -> None:
        """Persist ``rows`` AND keep them on the device until released."""
        ...

    def gather_staged(self, idx) -> torch.Tensor:
        """Like ``gather``, but staged rows come from the device."""
        ...

    def release_staged(self, idx) -> None:
        """Drop the device copies of ``idx``."""
        ...

    @property
    def nbytes(self) -> int: ...


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int64).ravel(),
                           device=device)


class DenseStore:
    """The experiment's device-resident ``[N, P]`` plane behind the store
    API: ``buffer`` is the tensor handed in, never copied."""

    kind = "dense"

    def __init__(self, buffer: torch.Tensor, cell: int = 0):
        self.buffer = buffer
        self.stats = ClientStats.create(buffer.shape[0], cell)

    @property
    def num_clients(self) -> int:
        return self.buffer.shape[0]

    @property
    def row_size(self) -> int:
        return self.buffer.shape[1]

    def gather(self, idx) -> torch.Tensor:
        return self.buffer[_index(idx, self.buffer.device)]

    def scatter(self, idx, rows) -> None:
        """Row write in place."""
        self.buffer.index_copy_(0, _index(idx, self.buffer.device),
                                rows.to(self.buffer.device))

    def iter_chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        for start in range(0, self.num_clients, chunk_size):
            yield self.buffer[start:start + chunk_size].to(
                "cpu", copy=True).numpy()

    # the whole plane lives on the device: every row is already staged
    def stage(self, idx, rows) -> None:
        self.scatter(idx, rows)

    def gather_staged(self, idx) -> torch.Tensor:
        return self.gather(idx)

    def release_staged(self, idx) -> None:
        pass

    @property
    def nbytes(self) -> int:
        return self.buffer.numel() * 4


class PagedStore:
    """Host-paged cold store: base row + sparse overlay + dense blocks,
    serving rows to ``device``."""

    kind = "paged"

    #: a chunk's overlay rows move into a dense block once this fraction
    #: of the chunk has been written (a dict of rows is smaller below it,
    #: a block faster to read above it)
    PROMOTE_FRAC = 0.5

    def __init__(self, base_row: np.ndarray, num_clients: int,
                 chunk_size: int, cell: int = 0,
                 stage_rows: Optional[int] = None, device="cpu"):
        self.base = np.ascontiguousarray(base_row, dtype=np.float32)
        self.n = int(num_clients)
        self.chunk = int(chunk_size)
        if self.chunk <= 0:
            raise ValueError(f"chunk_size must be positive; got {chunk_size}")
        self.device = torch.device(device)
        self._rows: Dict[int, np.ndarray] = {}        # sparse overlay
        self._blocks: Dict[int, np.ndarray] = {}      # chunk id -> [c, P]
        self.touched = np.zeros(self.n, bool)
        self.stats = ClientStats.create(self.n, cell)
        # a device LRU of in-flight rows, at most ``stage_rows`` of them:
        # the fold that consumes a staged row reads its device copy back
        # with no host round trip (an fp32 round trip keeps the value, so
        # a miss costs a copy, never a different result)
        self.stage_rows = int(stage_rows) if stage_rows else 0
        self._staged: "OrderedDict[int, torch.Tensor]" = OrderedDict()

    # -- geometry ------------------------------------------------------
    @property
    def num_clients(self) -> int:
        return self.n

    @property
    def row_size(self) -> int:
        return self.base.shape[0]

    def _bounds(self, cid: int):
        start = cid * self.chunk
        return start, min(start + self.chunk, self.n)

    # -- reads ---------------------------------------------------------
    def row(self, i: int) -> np.ndarray:
        cid = i // self.chunk
        block = self._blocks.get(cid)
        if block is not None:
            return block[i - cid * self.chunk]
        r = self._rows.get(i)
        return self.base if r is None else r

    def gather(self, idx) -> torch.Tensor:
        """The rows of ``idx`` on the device — the active plane's O(K·P)
        read: assembled into one host buffer (pinned when the device is
        a card; PyTorch's pinned allocator keeps it until the copy has
        run) and copied in one ``non_blocking`` copy."""
        idx = np.asarray(idx, np.int64).ravel()
        host = torch.empty((idx.shape[0], self.row_size), dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")
        out = host.numpy()
        for j, i in enumerate(idx):
            out[j] = self.row(int(i))
        if self.device.type == "cpu":
            return host
        return host.to(self.device, non_blocking=True)

    def assemble(self, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` as one contiguous host block (a promoted
        block itself, not a copy, when the range is exactly that block)."""
        stop = min(stop, self.n)
        cid0 = start // self.chunk
        if (cid0 in self._blocks and start == cid0 * self.chunk
                and stop == min(start + self.chunk, self.n)):
            return self._blocks[cid0]
        out = np.broadcast_to(self.base, (stop - start, self.row_size)).copy()
        lo, hi = start // self.chunk, (max(stop - 1, start)) // self.chunk
        for cid in range(lo, hi + 1):
            block = self._blocks.get(cid)
            if block is None:
                continue
            b0, b1 = self._bounds(cid)
            s, e = max(b0, start), min(b1, stop)
            out[s - start:e - start] = block[s - b0:e - b0]
        if self._rows:
            for i in range(start, stop):
                r = self._rows.get(i)
                if r is not None:
                    out[i - start] = r
        return out

    def iter_chunks(self, chunk_size: Optional[int] = None
                    ) -> Iterator[np.ndarray]:
        """The whole (virtual) plane as assembled host blocks, one at a
        time — what ``chunked_client_divergence`` / ``chunked_pairwise``
        take."""
        c = self.chunk if chunk_size is None else int(chunk_size)
        for start in range(0, self.n, c):
            yield self.assemble(start, start + c)

    # -- writes --------------------------------------------------------
    def scatter(self, idx, rows) -> None:
        """Write trained rows back to the cold store: one device-to-host
        copy of ``rows`` (a tensor or an array), then a host write a
        row."""
        idx = np.asarray(idx, np.int64).ravel()
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().to("cpu", torch.float32).numpy()
        rows = np.asarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[0] != idx.shape[0]:
            raise ValueError(f"scatter: rows {rows.shape} do not match "
                             f"idx {idx.shape}")
        dirty_chunks = set()
        for j, i in enumerate(idx):
            i = int(i)
            cid = i // self.chunk
            block = self._blocks.get(cid)
            if block is not None:
                block[i - cid * self.chunk] = rows[j]
            else:
                self._rows[i] = rows[j].copy()
                dirty_chunks.add(cid)
        self.touched[idx] = True
        for cid in dirty_chunks:
            self._maybe_promote(cid)

    def _maybe_promote(self, cid: int) -> None:
        b0, b1 = self._bounds(cid)
        if self.touched[b0:b1].sum() < self.PROMOTE_FRAC * (b1 - b0):
            return
        block = np.broadcast_to(self.base,
                                (b1 - b0, self.row_size)).copy()
        for i in range(b0, b1):
            r = self._rows.pop(i, None)
            if r is not None:
                block[i - b0] = r
        self._blocks[cid] = block

    # -- device staging ------------------------------------------------
    def stage(self, idx, rows) -> None:
        """Write through: persist to the cold store AND keep a device copy
        of each row (LRU, at most ``stage_rows``)."""
        idx_h = np.asarray(idx, np.int64).ravel()
        self.scatter(idx_h, rows)
        if not self.stage_rows:
            return
        rows = torch.as_tensor(rows, dtype=torch.float32).to(self.device)
        rows = rows.clone()     # the caller may write its block again
        for j, i in enumerate(idx_h):
            i = int(i)
            self._staged.pop(i, None)
            self._staged[i] = rows[j]
        while len(self._staged) > self.stage_rows:
            self._staged.popitem(last=False)

    def gather_staged(self, idx) -> torch.Tensor:
        idx_h = np.asarray(idx, np.int64).ravel()
        if not self._staged:
            return self.gather(idx_h)
        parts = [self._staged.get(int(i)) for i in idx_h]
        if all(p is not None for p in parts):
            return torch.stack(parts)
        cold = self.gather(idx_h)
        return torch.stack([cold[j] if p is None else p
                            for j, p in enumerate(parts)])

    def release_staged(self, idx) -> None:
        for i in np.asarray(idx, np.int64).ravel():
            self._staged.pop(int(i), None)

    # -- accounting ----------------------------------------------------
    @property
    def num_touched(self) -> int:
        return int(self.touched.sum())

    @property
    def nbytes(self) -> int:
        return (self.base.nbytes
                + sum(r.nbytes for r in self._rows.values())
                + sum(b.nbytes for b in self._blocks.values())
                + self.touched.nbytes)


def build_store(kind: str, base_row: torch.Tensor, num_clients: int,
                chunk_size: int, cell: int = 0,
                stage_rows: Optional[int] = None):
    """The store ``kind`` of ``num_clients`` clients, all starting at
    ``base_row`` (the initial global row, on the experiment's device):
    dense, the ``[N, P]`` plane ``base_row.repeat(N, 1)`` on that device;
    paged, a cold store in host memory that serves rows to it."""
    if kind == "dense":
        return DenseStore(base_row.repeat(num_clients, 1), cell)
    if kind == "paged":
        base = base_row.detach().to("cpu", copy=True).numpy()
        return PagedStore(base, num_clients, chunk_size, cell, stage_rows,
                          base_row.device)
    raise ValueError(f"unknown client store {kind!r}; "
                     "expected 'dense' or 'paged'")
