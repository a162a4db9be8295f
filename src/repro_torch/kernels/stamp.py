"""Device stamps: a one-thread kernel (``csrc/stamp.cu``) that writes the
card's ``%globaltimer`` into the next slot of a per-device ring, and the
host's decoding of that ring.

The phase spans of ``repro_torch.utils.spans`` place a stamp at a phase's
start and end; captured into a round's CUDA graph, the stamps run on every
replay. A slot is ``(timer_ns, sequence, tag)``: the sequence number comes
from the kernel's ``atomicAdd`` on the ring's counter, and the host counts
the stamps it launches and replays (:attr:`Ring.counted`), so it knows each
stamp's sequence number without reading the counter. :func:`decode` finds
a stamp by its sequence number and checks its tag.

Replaces no TPU kernel (see the source's note). There is no plain version:
a stamp reads the card's clock, which a CPU tensor has not; the spans take
no stamps on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.build import error_string, load_function

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p)


class Ring:
    """One device's stamp ring: ``slots [capacity, 3]`` int64 (sequence
    ``-1`` where nothing was written) and its counter, both on ``device``;
    ``counted`` the stamps launched or replayed on it so far, by the host's
    count."""

    def __init__(self, device: torch.device, capacity: int):
        self.device = device
        self.capacity = int(capacity)
        self.slots = torch.full((self.capacity, 3), -1, dtype=torch.int64,
                                device=device)
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.counted = 0


def stamp(ring: Ring, tag: int) -> None:
    """Launch one stamp of ``tag`` on the current stream of the ring's
    device (captured, where that stream is capturing). The caller counts
    it in ``ring.counted`` when it runs: at the launch, or at each replay
    of the graph that captured it."""
    fn = load_function("stamp", "stamp_write", _ARGTYPES)
    stream = torch.cuda.current_stream(ring.device).cuda_stream
    with torch.cuda.device(ring.device):
        err = fn(ring.counter.data_ptr(), ring.slots.data_ptr(),
                 ring.capacity, int(tag), stream)
    if err:
        raise RuntimeError("stamp: kernel launch failed: "
                           + error_string("stamp", err))
    stamp.launches += 1


#: kernel launches so far (a plain count, reset by whoever reads it)
stamp.launches = 0


def decode(slots: np.ndarray, expected: Sequence[tuple]) -> np.ndarray:
    """The timer values [ns] of the stamps ``expected`` — ``(sequence,
    tag)`` pairs — in a host copy of a ring's ``slots``. Raises where a
    stamp's slot holds a later stamp (the ring wrapped before it was read)
    or another tag or an earlier sequence (the host's count and the card's
    disagree, or the stamp has not run)."""
    if not len(expected):
        return np.zeros(0, dtype=np.int64)
    seq = np.asarray([s for s, _ in expected], dtype=np.int64)
    tag = np.asarray([t for _, t in expected], dtype=np.int64)
    got = slots[seq % len(slots)]
    lost = got[:, 1] > seq
    if lost.any():
        raise RuntimeError(
            f"stamp ring: {int(lost.sum())} of {len(seq)} stamps were "
            f"overwritten before they were read (the ring holds "
            f"{len(slots)}): read the spans sooner")
    bad = (got[:, 1] != seq) | (got[:, 2] != tag)
    if bad.any():
        i = int(np.argmax(bad))
        raise RuntimeError(
            f"stamp ring: stamp {int(seq[i])} reads sequence "
            f"{int(got[i, 1])} tag {int(got[i, 2])}, not tag {int(tag[i])}: "
            "a stamp ran that the host did not count, or has not run")
    return got[:, 0].copy()
