"""The ``[rows, P]`` client plane split by columns over a ``model`` mesh
(``ExperimentSpec(p_shards=m)``, the reference's P-axis sharding of the
traced carry).

:class:`ColumnBlocks` holds ``m`` contiguous column blocks, block ``i``
on the device of mesh position ``i``; position 0 is the lead, where the
round keeps everything it reads whole (the global row, the server state,
training, the fold and evaluation). Every hand-off between positions is
an explicit ``.to(device)``, and every cross-position sum is taken on the
lead in position order, so a mesh that names one device several times
runs the code a mesh over distinct cards runs.

The round body writes the plane and reads it through two hand-offs
(``core.engine.build_round_phases``): :meth:`ColumnBlocks.stage` keeps
the round's rows on the lead, one contiguous column block a position,
and the plane's flush (the round body's ``flush``) moves each block to
its position, writes it there and reduces that position's partial
divergence ``Σ(x − g)²`` over its columns into :attr:`partials` on the
lead. On the card the lead's round and each position's flush are
separate CUDA graphs (one graph cannot span cards), ordered by the
streams' events (``core.engine.TracedProgram``).

Between runs an experiment keeps its plane as these blocks; reading it
whole (:meth:`assemble`, ``FLExperiment.client_plane``) gives a copy.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


class ColumnBlocks:
    """A ``[rows, P]`` tensor as column blocks: ``blocks[i]`` is columns
    ``bounds[i]`` on mesh position ``i``'s device.

    Enough of a tensor's surface for the client store's row reads and
    writes (``shape``, ``device`` — the lead's —, ``numel``, indexing
    rows, ``index_copy_`` along rows) and for ``plane_spec`` (``ndim``),
    each read or write assembling or splitting by explicit copies. ``partials``: the round body's
    per-position partial divergences (``[n]`` fp32 each, on the lead),
    ``pending``: the rows it staged and not yet flushed."""

    def __init__(self, blocks: Sequence[torch.Tensor],
                 bounds: Sequence[Tuple[int, int]]):
        self.blocks = list(blocks)
        self.bounds = tuple((int(a), int(b)) for a, b in bounds)
        self.partials: Optional[list] = None
        self.pending = None

    @classmethod
    def split(cls, x: torch.Tensor, devices) -> "ColumnBlocks":
        """``x [rows, P]`` in ``len(devices)`` equal column blocks (``P``
        must divide), block ``i`` copied to ``devices[i]``."""
        m, p = len(devices), x.shape[-1]
        if p % m:
            raise ValueError(f"{p} columns do not split over {m} positions")
        w = p // m
        bounds = [(i * w, (i + 1) * w) for i in range(m)]
        return cls([x[..., a:b].to(dev, copy=True)
                    for (a, b), dev in zip(bounds, devices)], bounds)

    # -- the tensor surface -------------------------------------------------
    @property
    def devices(self) -> tuple:
        return tuple(b.device for b in self.blocks)

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.blocks[0].shape[0], self.bounds[-1][1]))

    ndim = 2

    def numel(self) -> int:
        return sum(b.numel() for b in self.blocks)

    def __getitem__(self, rows) -> torch.Tensor:
        """Rows ``rows`` (a slice or an index tensor) assembled on the
        lead: a new tensor."""
        if isinstance(rows, torch.Tensor):
            return torch.cat([b[rows.to(b.device)].to(self.device)
                              for b in self.blocks], dim=-1)
        return torch.cat([b[rows].to(self.device) for b in self.blocks],
                         dim=-1)

    def index_copy_(self, dim: int, idx: torch.Tensor,
                    rows: torch.Tensor) -> "ColumnBlocks":
        """Rows ``idx`` written with ``rows [k, P]``, each block's columns
        on its own position."""
        if dim != 0:
            raise ValueError("ColumnBlocks writes whole rows (dim 0)")
        for blk, (a, b) in zip(self.blocks, self.bounds):
            blk.index_copy_(0, idx.to(blk.device), rows[:, a:b].to(blk.device))
        return self

    def assemble(self, device=None) -> torch.Tensor:
        """The whole ``[rows, P]`` tensor on ``device`` (default the
        lead's): a copy."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([b.to(dev) for b in self.blocks], dim=-1)

    def columns(self, cols: slice, rows: int) -> torch.Tensor:
        """``[rows, cols]`` gathered on the lead from the blocks that hold
        them (a column range may straddle a block boundary): a new
        tensor."""
        start, stop = cols.start or 0, cols.stop
        parts = [blk[:rows, max(start, a) - a:min(stop, b) - a].to(
                     self.device)
                 for blk, (a, b) in zip(self.blocks, self.bounds)
                 if max(start, a) < min(stop, b)]
        return torch.cat(parts, dim=-1)

    # -- copies ---------------------------------------------------------------
    def head(self, rows: int) -> "ColumnBlocks":
        """The first ``rows`` rows, each block's its own copy."""
        return ColumnBlocks([b[:rows].clone() for b in self.blocks],
                            self.bounds)

    def padded(self, extra: int) -> "ColumnBlocks":
        """The blocks with ``extra`` zero rows after them (the carry's
        spare rows of the padding lanes), each on its own position."""
        return ColumnBlocks(
            [torch.cat([b, b.new_zeros((extra, b.shape[1]))]) for b in
             self.blocks], self.bounds)

    def clone(self) -> "ColumnBlocks":
        out = ColumnBlocks([b.clone() for b in self.blocks], self.bounds)
        if self.partials is not None:
            out.partials = [p.clone() for p in self.partials]
        return out

    def copy_(self, src: "ColumnBlocks") -> "ColumnBlocks":
        """``src``'s values in place, block by block (and its partials,
        where both hold them)."""
        if src.bounds != self.bounds:
            raise ValueError(f"column blocks {src.bounds} into {self.bounds}")
        for dst, blk in zip(self.blocks, src.blocks):
            dst.copy_(blk)
        if self.partials is not None and src.partials is not None:
            for dst, p in zip(self.partials, src.partials):
                dst.copy_(p)
        return self

    def same_layout(self, devices) -> bool:
        """True where the blocks lie, in order, on ``devices``."""
        return (len(devices) == len(self.blocks)
                and all(torch.device(d) == b.device
                        for d, b in zip(devices, self.blocks)))

    # -- the round body's hand-offs ----------------------------------------
    def stage(self, store: torch.Tensor, rows: torch.Tensor) -> None:
        """Keep the round's writes on the lead for the next flush: the
        plane rows ``store [k]`` and each position's columns of ``rows
        [k, P]`` as a contiguous block."""
        self.pending = (store, [rows[:, a:b].contiguous()
                                for a, b in self.bounds])

    def handoff(self, i: int, gvec: torch.Tensor, pending=None) -> tuple:
        """What position ``i``'s flush reads, on the lead: the row
        indices and its column block of the rows ``pending`` (a
        :meth:`stage`'s ``(store, blocks)``, or ``None``: no write), and
        its columns of the global row ``gvec``."""
        a, b = self.bounds[i]
        if pending is None:
            return None, None, gvec[a:b]
        store, rows = pending
        return store, rows[i], gvec[a:b]
