"""CUDA graphs of the fixed-shape solves (SAO, FEDL).

A solve is thousands of small sequential launches with no host read
between them, so on the card its cost is the host's launch rate. Captured
once as a CUDA graph per shape and replayed, it costs only its device
work. :class:`CapturedSolve` holds one such graph: its inputs are copied
into the graph's own tensors, the graph replays and the outputs are copied
out. :func:`replays` says where a call takes the graph: a CUDA tensor,
outside any capture (a solve inside a captured round is part of that
round's graph, and a capture cannot hold another) and outside
:func:`eager_solves`. :class:`GraphCache` keeps a solver's graphs.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.utils.spans import span

_eager_depth = 0


@contextlib.contextmanager
def eager_solves():
    """Run every solve's eager body inside the block, on any device: the
    yardstick a graph is held to, and a warm-up that captures nothing."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def replays(t: torch.Tensor) -> bool:
    """True where a solve on ``t`` replays its captured graph."""
    return (t.is_cuda and _eager_depth == 0
            and not torch.cuda.is_current_stream_capturing())


class CapturedSolve:
    """``body(arr, scalars, mask)`` captured as a CUDA graph for one shape:
    ``arr`` a dict of tensors, ``scalars`` fp32 values (Python numbers, or
    tensors: 0-d, or one a lane), ``mask`` a bool tensor or ``None``. A call loads its
    inputs by device copies and fills (nothing waits for the card), replays
    and returns clones of the outputs (a later replay overwrites them)."""

    def __init__(self, body: Callable, arr: Dict[str, torch.Tensor],
                 scalars: Sequence, mask: Optional[torch.Tensor]):
        dev = next(iter(arr.values())).device
        self.arr = {k: v.clone() for k, v in arr.items()}
        self.scalars = [torch.empty(getattr(v, "shape", ()),
                                    dtype=torch.float32, device=dev)
                        for v in scalars]
        self.mask = None if mask is None else mask.clone()
        self._load(arr, scalars, mask)
        # one eager solve first, on a side stream, so that nothing is
        # first touched (a kernel's module, an allocator block) during
        # the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body(self.arr, self.scalars, self.mask)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # a capture stream of the solve's own device (the graph class's
        # default stream lives on the device of its first use)
        with torch.cuda.device(dev), torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(dev)):
            self.out = body(self.arr, self.scalars, self.mask)

    def _load(self, arr, scalars, mask):
        for k, v in self.arr.items():
            v.copy_(arr[k])
        for dst, v in zip(self.scalars, scalars):
            if isinstance(v, torch.Tensor):
                dst.copy_(v)
            else:
                dst.fill_(v)
        if mask is not None:
            self.mask.copy_(mask)

    def __call__(self, arr, scalars, mask):
        self._load(arr, scalars, mask)
        self.graph.replay()
        return type(self.out)(*(v.clone() for v in self.out))


def graph_key(arr: Dict[str, torch.Tensor], mask, *static) -> tuple:
    """The cache key of a solve's graph: its device, lane count, whether
    it is masked, its arrays' names, its leading (cohort) shape — ``()``
    for one solve — and its static parameters."""
    J = arr["J"]
    return (J.device, J.shape[-1], mask is None, tuple(sorted(arr)),
            tuple(J.shape[:-1])) + static


class GraphCache:
    """A solver's captured solves by key, LRU-bounded at ``max_graphs``.
    A key is captured at its second call (the first runs the eager body),
    so a shape met once — the selection of a selector whose set size
    changes from round to round — costs no capture, and a run whose shape
    repeats replays from its second solve on."""

    def __init__(self, max_graphs: int = 8, max_seen: int = 256):
        self.graphs: "OrderedDict[tuple, CapturedSolve]" = OrderedDict()
        self.seen: "OrderedDict[tuple, None]" = OrderedDict()
        self.max_graphs, self.max_seen = max_graphs, max_seen

    def __call__(self, key: tuple, body: Callable, arr, scalars, mask):
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            return graph(arr, scalars, mask)
        if key not in self.seen:
            self.seen[key] = None
            _trim(self.seen, self.max_seen)
            return body(arr, scalars, mask)
        with span("fl.capture", solve=getattr(body, "__name__", "solve")):
            graph = self.graphs[key] = CapturedSolve(body, arr, scalars,
                                                     mask)
        _trim(self.graphs, self.max_graphs)
        return graph(arr, scalars, mask)

    def clear(self) -> None:
        self.graphs.clear()
        self.seen.clear()


def _trim(cache: OrderedDict, size: int) -> None:
    while len(cache) > size:
        cache.popitem(last=False)
