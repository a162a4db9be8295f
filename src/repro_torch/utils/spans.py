"""Spans of the port's host stages and phases, on the clock of the
profiler's device records, and device stamps that time the phases inside
a captured round.

``span(name, device=None, **attrs)`` opens the ``record_function`` range
``name`` (every name starts with ``fl.``), so an operator's own
``torch.profiler`` profile shows it as before. While a torch profiler
records (``torch.autograd.profiler._is_profiler_enabled``, the profiler's
own flag) it also keeps the span: its name, start and end (Unix-epoch ns,
``time.time_ns``: the clock of the profiler's records), its id, its
parent's, its call's (the outermost open span's) and ``attrs``. Otherwise
it costs what ``record_function`` costs: the profiler is the only switch.

A span given a CUDA ``device`` is a phase with device work: it places a
stamp (``repro_torch.kernels.stamp``) at its start and at its end on that
device. Inside a CUDA graph capture (:func:`capture`) it always does, so
every replay times the phase; in eager code only while a profiler records.
:func:`replayed` counts a graph's stamps at each replay and, while a
profiler records, keeps their sequence numbers with the replay's span.
:func:`recorded` reads each device's ring once (after a sync of that
device) and turns every pair of stamps kept since into a ``device`` span
(an eager phase) or a ``replay`` span (a phase of a replayed graph), tagged
with its phase, call, program and round. Their times are the card's
``%globaltimer``: their durations compare with the profiler's, their
starts do not.

    with torch.profiler.profile(...):
        runner.run(rounds=10)
    spans = recorded()              # host, device and replay spans
"""
from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

__all__ = ["Span", "span", "capture", "replayed", "recorded", "clear",
           "recording", "SPAN_LIMIT", "RING_SLOTS"]

SPAN_LIMIT = 1 << 17     # spans kept; the oldest go first
RING_SLOTS = 1 << 16     # stamps a device's ring holds before it wraps


class Span(NamedTuple):
    """One span. ``kind``: ``"host"`` (the host's time in the block),
    ``"device"`` (an eager phase's stamps) or ``"replay"`` (a phase's
    stamps in a replayed graph). ``call``: the id of the outermost span
    open at its start (its own id for a root). Host spans' times are
    Unix-epoch ns, device and replay spans' the card's ``%globaltimer``."""
    name: str
    kind: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    call: Optional[int]
    attrs: dict

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Pending(NamedTuple):
    """A phase's two stamps, kept until :func:`recorded` reads them."""
    device: int
    start: tuple           # (sequence, tag)
    end: tuple
    name: str
    kind: str
    parent: Optional[int]
    call: Optional[int]
    attrs: dict


class Captured:
    """The stamps a graph capture placed on one device: ``tags`` in launch
    order and ``phases``, ``(name, start index, end index, attrs)``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.tags: List[int] = []
        self.phases: List[tuple] = []


class _Recorder:
    """What the module keeps: the spans, the open spans, each device's
    stamp ring, the stamps not yet read and the captures in progress."""

    def __init__(self):
        self.spans: deque = deque(maxlen=SPAN_LIMIT)
        self.stack: List[tuple] = []          # (id, call, attrs)
        self.ids = itertools.count(1)
        self.tags = itertools.count(1)
        self.rings: Dict[int, object] = {}
        self.pending: List[_Pending] = []
        self.captures: Dict[int, Captured] = {}


_rec = _Recorder()


def recording() -> bool:
    """True while a torch profiler records."""
    return _profiler._is_profiler_enabled


def _ring(device: torch.device):
    """``device``'s stamp ring, made at its first use: outside any
    capture, with one stamp run at once so that the kernel's module is
    loaded before a capture launches it."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    ring = _rec.rings.get(idx)
    if ring is None:
        from repro_torch.kernels import stamp as st
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a phase span inside a CUDA graph capture needs its "
                "device's stamp ring: capture under spans.capture(device)")
        ring = st.Ring(torch.device("cuda", idx), RING_SLOTS)
        st.stamp(ring, 0)
        ring.counted += 1
        _rec.rings[idx] = ring
    return ring


class span:
    """``with span("fl.train", device=dev, lane=0): ...`` — the module
    docstring. ``device``: a CUDA device stamps the phase (``None`` or a
    CPU device: a host span only)."""

    __slots__ = ("name", "device", "attrs", "rf", "kept", "start_ns",
                 "id", "stamps")

    def __init__(self, name: str, device=None, **attrs):
        if not name.startswith("fl."):
            raise ValueError(f"span names start with 'fl.', not {name!r}")
        self.name, self.attrs = name, attrs
        device = None if device is None else torch.device(device)
        self.device = device if device is not None and \
            device.type == "cuda" else None

    def __enter__(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.kept = recording()
        self.stamps = None
        if self.kept:
            parent = _rec.stack[-1] if _rec.stack else None
            self.id = next(_rec.ids)
            call = parent[1] if parent else self.id
            _rec.stack.append((self.id, call, self.attrs))
        if self.device is not None:
            self.stamps = self._stamp()
        if self.kept:
            self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.kept:
            end_ns = time.time_ns()
        if self.stamps is not None:
            self._stamp_end()
        if self.kept:
            _, call, _ = _rec.stack.pop()
            parent = _rec.stack[-1][0] if _rec.stack else None
            _rec.spans.append(Span(self.name, "host", self.start_ns, end_ns,
                                   self.id, parent, call, self.attrs))
        return self.rf.__exit__(*exc)

    def _stamp(self):
        """The start stamp: captured (its index in the capture), eager
        while recording (its ``(sequence, tag)``), else none."""
        from repro_torch.kernels.stamp import stamp
        if torch.cuda.is_current_stream_capturing():
            ring = _ring(self.device)
            cap = _rec.captures.get(ring.device.index)
            if cap is None:
                raise RuntimeError(
                    f"{self.name}: a phase span inside a CUDA graph capture "
                    "needs spans.capture(device) around the capture")
            tag = next(_rec.tags)
            stamp(ring, tag)
            cap.tags.append(tag)
            return ("captured", cap, len(cap.tags) - 1)
        if not self.kept:
            return None
        ring = _ring(self.device)
        tag = next(_rec.tags)
        stamp(ring, tag)
        ring.counted += 1
        return ("eager", ring, (ring.counted - 1, tag))

    def _stamp_end(self):
        from repro_torch.kernels.stamp import stamp
        how, where, start = self.stamps
        tag = next(_rec.tags)
        if how == "captured":
            stamp(_rec.rings[where.device.index], tag)
            where.tags.append(tag)
            where.phases.append((self.name, start, len(where.tags) - 1,
                                 self.attrs))
            return
        ring = where          # eager stamps are taken only while kept
        stamp(ring, tag)
        ring.counted += 1
        _rec.pending.append(_Pending(ring.device.index, start,
                                     (ring.counted - 1, tag), self.name,
                                     "device", self.id, _rec.stack[-1][1],
                                     self.attrs))


@contextlib.contextmanager
def capture(device):
    """Around a CUDA graph capture on ``device`` (entered before the
    capture starts): arms the device's stamp ring and yields the
    :class:`Captured` stamps the capture places, which each replay of the
    graph hands to :func:`replayed`."""
    device = torch.device(device)
    if device.type != "cuda":
        yield Captured(device)
        return
    ring = _ring(device)
    cap = Captured(ring.device)
    before = _rec.captures.get(ring.device.index)
    _rec.captures[ring.device.index] = cap
    try:
        yield cap
    finally:
        if before is None:
            del _rec.captures[ring.device.index]
        else:
            _rec.captures[ring.device.index] = before


def replayed(cap: Optional[Captured], **attrs) -> None:
    """Count one replay of the graph whose capture placed ``cap`` (call
    it with each replay, after it is launched); while a profiler records,
    keep each of its phases' stamps as a ``replay`` span to be read, its
    attrs the phase's, the innermost open span's and ``attrs``."""
    if cap is None or not cap.tags:
        return
    ring = _rec.rings[cap.device.index]
    base = ring.counted
    ring.counted += len(cap.tags)
    if not recording():
        return
    parent = _rec.stack[-1] if _rec.stack else None
    outer = dict(parent[2]) if parent else {}
    outer.update(attrs)
    for name, i, j, own in cap.phases:
        _rec.pending.append(_Pending(
            ring.device.index, (base + i, cap.tags[i]),
            (base + j, cap.tags[j]), name, "replay",
            parent[0] if parent else None, parent[1] if parent else None,
            {**outer, **own}))


def recorded() -> List[Span]:
    """Every span kept so far, in the order each ended (the device and
    replay spans after the host spans of their stamps), reading the
    stamps kept since the last call: one copy of each ring that holds
    some, after a sync of its device."""
    if _rec.pending:
        from repro_torch.kernels.stamp import decode
        by_dev: Dict[int, List[_Pending]] = {}
        for p in _rec.pending:
            by_dev.setdefault(p.device, []).append(p)
        for idx, todo in by_dev.items():
            torch.cuda.synchronize(idx)
            slots = _rec.rings[idx].slots.cpu().numpy()
            times = decode(slots, [s for p in todo for s in (p.start, p.end)])
            for k, p in enumerate(todo):
                _rec.spans.append(Span(
                    p.name, p.kind, int(times[2 * k]), int(times[2 * k + 1]),
                    next(_rec.ids), p.parent, p.call, p.attrs))
        _rec.pending.clear()
    return list(_rec.spans)


def clear() -> None:
    """Drop every span kept and every stamp not yet read (the rings and
    their counts stay)."""
    _rec.spans.clear()
    _rec.pending.clear()
