"""Weighted row sum over the flat client plane — FedAvg's eq.-(4) fold as
one GEMV, ``[N, P] × [N] -> [P]`` in fp32 from fp32 or bf16 rows; with a
leading lane axis (a cohort's seeds), ``[B, N, P] × [B, N] -> [B, P]`` in
one launch, the lane as the grid's second axis.

Replaces the Pallas TPU kernel ``src/repro/kernels/flat_aggregate.py``
(``flat_aggregate`` / ``_flat_aggregate_kernel``) with the hand-written
CUDA kernel ``csrc/flat_aggregate.cu``. On the card it is bound by bytes:
the live rows are read once for two flops per element, so it runs as fast
as the loads it keeps in flight. A block compacts the live rows into shared
memory, splits them over 4 row groups (each lane issuing eight 16-byte
loads before its FMAs: two rows of four vectors when N ≤ 8, eight rows of
one above) and adds the groups' partial sums in a fixed order — no
atomics, so the fold is deterministic.

Both versions skip rows whose weight is not positive, so a NaN row at
weight 0 never reaches the fold (0·NaN = NaN); the kernel by not reading
the row, the plain version by zeroing it first. bf16 rows (a bf16 model's
plane) launch the bf16 instance, which widens each element exactly before
its FMA and sums in the fp32 instance's order: its result is that
instance's on the widened rows, bit for bit, at half the bytes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import error_string, load_function

_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3
             + (ctypes.c_void_p,))
_SYMBOLS = {torch.float32: "flat_aggregate_f32",
            torch.bfloat16: "flat_aggregate_bf16"}


def flat_aggregate_plain(flat: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: zero the rows with ``w <= 0``, then the
    naive multiply-and-reduce of ``ref.flat_aggregate_ref`` (lanes
    included), in fp32 whatever the rows' float type."""
    keep = (weights > 0.0)[..., None]
    return ref.flat_aggregate_ref(
        torch.where(keep, flat, torch.zeros((), dtype=flat.dtype,
                                            device=flat.device)), weights)


def flat_aggregate(flat: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``Σ_n w_n·flat[n, :]`` over the rows with ``w_n > 0``, for each lane
    of a leading lane axis if there is one.

    flat ``[N, P]`` and weights ``[N]``, or flat ``[B, N, P]`` and weights
    ``[B, N]``; fp32 or bf16 rows, fp32 weights, both contiguous on one
    device; an fp32 result. A CUDA tensor launches the kernel; a CPU tensor
    takes :func:`flat_aggregate_plain`.
    """
    if not flat.is_cuda:
        return flat_aggregate_plain(flat, weights)
    if flat.dim() not in (2, 3) or weights.shape != flat.shape[:-1]:
        raise ValueError(f"flat_aggregate: want flat [N, P] and weights [N], "
                         f"or [B, N, P] and [B, N]; got {tuple(flat.shape)} "
                         f"and {tuple(weights.shape)}")
    if flat.dtype not in _SYMBOLS or weights.dtype != torch.float32:
        raise TypeError(f"flat_aggregate: the kernel takes float32 or "
                        f"bfloat16 rows and float32 weights; got "
                        f"{flat.dtype} and {weights.dtype}")
    if weights.device != flat.device:
        raise ValueError("flat_aggregate: flat and weights lie on different "
                         f"devices ({flat.device}, {weights.device})")
    if not (flat.is_contiguous() and weights.is_contiguous()):
        raise ValueError("flat_aggregate: the kernel takes contiguous tensors")
    *lanes, n, p = flat.shape
    b = lanes[0] if lanes else 1
    # rows are addressed in 64 bits (a plane may pass 2^31 elements, as 16
    # tinyllama clients' MLP leaves do); a row's columns in 32
    if max(n, p) >= 2 ** 31 or b > 65535:
        raise ValueError(f"flat_aggregate: {tuple(flat.shape)} exceeds the "
                         "kernel's 32-bit sizes or 65535 lanes")
    out = torch.empty((*lanes, p), dtype=torch.float32, device=flat.device)
    fn = load_function("flat_aggregate", _SYMBOLS[flat.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    with torch.cuda.device(flat.device):
        err = fn(flat.data_ptr(), weights.data_ptr(), out.data_ptr(), b, n,
                 p, stream)
    if err:
        raise RuntimeError("flat_aggregate: kernel launch failed: "
                           + error_string("flat_aggregate", err))
    flat_aggregate.launches += 1
    return out


#: kernel launches so far (a plain count, reset by whoever reads it)
flat_aggregate.launches = 0
