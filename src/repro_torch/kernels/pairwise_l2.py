"""Pairwise squared L2 distances, ``[N, F] × [M, F] -> [N, M]`` in fp32 —
K-means assignment and k-means++ (M = clusters, F = the feature layer)
and, with the global row as the one centroid, the divergence signal
(M = 1, F = P). With a leading lane axis (a cohort's seeds), ``[B, N, F]
× [B, M, F] -> [B, N, M]`` in one launch (plus its ``slab_sum``), each
lane's operands at their own lane stride, so the divergence reads the
first N rows of each lane of a ``[B, N + pad, P]`` plane in place. Each
lane keeps the slab plan of its one-lane call (a function of N, M and F),
so it sums in the same order and gives that call's bits.

Replaces the Pallas TPU kernel ``src/repro/kernels/pairwise_l2.py``
(``pairwise_l2`` / ``_pairwise_l2_kernel``) with the hand-written CUDA
kernels of ``csrc/pairwise_l2.cu``. On the card they are bound by bytes
(three flops per eight bytes read). They compute the direct ``Σ(x−c)²``
— not the TPU body's per-slab ``‖x‖²+‖c‖²−2x·c``, which cancels badly
for a client row close to the global row — over slabs of F, each (pair,
slab) partial through a fixed-shape tree; when F is cut into slabs a
second launch adds each pair's partials in a fixed order: no atomics,
deterministic. :func:`plan_pairwise` picks the kernel and its plan from
the call's shapes alone:

- ``pairwise_l2_centroid_walk_kernel`` (:func:`plan_centroids`): 2 to
  ``MAX_CENTROIDS`` centroids over an F that holds ``TARGET_BLOCKS``
  slabs of ``CENTROID_SLAB`` columns (an LM's whole embedding table). A
  block walks a group of rows against every centroid on its slab, so
  each slab of x and of c leaves HBM once.
- else F is cut by :func:`plan_slabs` (about ``TARGET_BLOCKS`` (pair,
  slab) blocks, a function of N, M and F) and a block takes one (pair,
  slab), ``pairwise_l2_kernel``; or, where the (lane, centroid, slab)
  blocks alone fill the card, ``pairwise_l2_walk_kernel`` walks all the
  rows of a slab of one centroid (:func:`plan_rows`), so each slab of the
  centroid is read once.

The divergence (M = 1, :func:`divergence_sq`) cuts F into slabs of a
fixed width (:func:`plan_divergence`, a function of F alone), so a row's
bits do not depend on how many rows share its call: a plane reduced in
chunks gives the bits of one call over all its rows. A bf16 x (a bf16
model's plane) launches the bf16 instance, which reads x at half the
bytes and widens each element exactly before the subtraction; c, only M
rows, is widened here. Its result is the fp32 instance's on the widened
x, bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import error_string, load_function

_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
             + (ctypes.c_longlong,) * 2 + (ctypes.c_int,) * 4
             + (ctypes.c_void_p,))
TARGET_BLOCKS = 528                # about four blocks an SM of an H100
MAX_ROWS = 64                      # rows of x a block walks at most (the
                                   # kernel's kMaxRows)
MIN_SLAB = 2048                    # floats of F a slab at least (8 a thread)
DIVERGENCE_SLAB = 8128             # the divergence's slab: plan_slabs(40, 1,
                                   # 113744)'s width, the main path's plan
MAX_CENTROIDS = 16                 # centroids the centroid walk takes at
                                   # most (the kernel's kMaxCentroids)
MAX_SUMS = 64                      # (row, centroid) sums a thread of it
                                   # holds (kMaxSums)
GROUP_ROWS = 16                    # rows of x a block of it takes at most
                                   # (kGroupRows; the launch refuses a plan
                                   # whose rows differ from the kernel's)
CENTROID_SLAB = 4096               # floats of F its slab at least
CENTROID_SLABS = 4096              # its slabs at most
_SYMBOLS = {torch.float32: "pairwise_l2_f32",
            torch.bfloat16: "pairwise_l2_bf16"}
KERNELS = ("pairwise_l2_kernel", "pairwise_l2_walk_kernel",
           "pairwise_l2_centroid_walk_kernel")


def plan_slabs(n: int, m: int, f: int, target: int = TARGET_BLOCKS):
    """``(slabs, width)``: F cut into ``slabs`` slabs of ``width`` columns
    (a multiple of 4, the last slab possibly shorter), so that the ``n·m``
    pairs times the slabs come to about ``target`` blocks, each slab at
    least ``MIN_SLAB`` wide. One slab when the pairs alone are that many.
    A function of the shapes alone, so the bits depend on the input
    only. A cohort's lanes keep their one-lane plan (B lanes bring B
    times the blocks)."""
    pairs = n * m
    want = 1
    if 0 < pairs < target:
        want = max(1, min(-(-target // pairs), f // MIN_SLAB))
    per = -(-f // want)                     # columns a slab, then
    width = max(4, -(-per // 4) * 4)        # up to a multiple of 4
    return max(1, -(-f // width)), width


def plan_divergence(f: int):
    """``(slabs, width)`` of the one-centroid call: F cut into slabs of
    ``DIVERGENCE_SLAB`` columns (one slab, ``f`` rounded up to a multiple
    of 4, when F is narrower). A function of F alone — not of the rows in
    the call, as :func:`plan_slabs` is — so each row's divergence is the
    same bits whether it is reduced alone, in a chunk or in the whole
    plane."""
    width = min(DIVERGENCE_SLAB, max(4, -(-f // 4) * 4))
    return max(1, -(-f // width)), width


def plan_rows(lanes: int, n: int, m: int, slabs: int,
              target: int = TARGET_BLOCKS) -> int:
    """Rows of x a block takes: all ``n`` (at most ``MAX_ROWS``) where the
    ``lanes·m·slabs`` (lane, centroid, slab) blocks alone reach ``target``,
    so that each slab of c leaves HBM once, not once a row; else one. The
    rows a block change which block adds a (pair, slab) partial, not how,
    so the bits do not depend on them."""
    return min(n, MAX_ROWS) if lanes * m * slabs >= target else 1


def plan_centroids(n: int, m: int, f: int):
    """``(slabs, width, rows)`` of the centroid walk, or None where the
    call keeps the other kernels: 2 to ``MAX_CENTROIDS`` centroids, and F
    wide enough for ``TARGET_BLOCKS`` slabs of ``CENTROID_SLAB`` columns.
    F is cut into that many slabs, at most ``CENTROID_SLABS`` (the second
    pass adds a few thousand partials a pair), each column in one slab. A
    block takes ``rows`` rows of x against every centroid: ``GROUP_ROWS``,
    or fewer so that rows × (m up to 4, 8 or 16) ≤ ``MAX_SUMS``. A
    function of the shapes alone — not of the lanes, so each lane of a
    call keeps its one-lane plan, nor of N for the slabs."""
    want = min(CENTROID_SLABS, f // CENTROID_SLAB)
    if not 2 <= m <= MAX_CENTROIDS or want < TARGET_BLOCKS:
        return None
    per = -(-f // want)                     # columns a slab, then
    width = -(-per // 4) * 4                # up to a multiple of 4
    slots = max(4, 1 << (m - 1).bit_length())
    return -(-f // width), width, min(n, GROUP_ROWS, MAX_SUMS // slots)


def plan_kernel(lanes: int, n: int, m: int, slabs: int, width: int):
    """``(kernel, slabs, width, rows)`` on a slab plan of the first two
    ``KERNELS``: the walk of one centroid's slab where :func:`plan_rows`
    gives more than one row, else a block a (pair, slab)."""
    rows = plan_rows(lanes, n, m, slabs)
    return KERNELS[1 if rows > 1 else 0], slabs, width, rows


def plan_pairwise(lanes: int, n: int, m: int, f: int):
    """``(kernel, slabs, width, rows)`` of a :func:`pairwise_l2` call over
    ``lanes`` lanes of ``[n, f] × [m, f]``: the kernel of ``KERNELS`` that
    runs it (the centroid walk where :func:`plan_centroids` takes the
    shapes, else :func:`plan_kernel` on :func:`plan_slabs`), F's slab plan
    and the rows a block takes: what the launch is given. The slab plan,
    and so the bits, are the same at any number of lanes."""
    walk = plan_centroids(n, m, f)
    if walk is not None:
        return (KERNELS[2], *walk)
    return plan_kernel(lanes, n, m, *plan_slabs(n, m, f))


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Each lane of ``t`` (``[.., R, F]``) is a row-major ``[R, F]`` block;
    the lanes may lie at any stride."""
    return (t.stride(-1) == 1 or t.shape[-1] <= 1) and (
        t.stride(-2) == t.shape[-1] or t.shape[-2] <= 1)


def pairwise_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[N, M]`` between the rows of x ``[N, F]`` and
    c ``[M, F]``, or ``[B, N, M]`` lane by lane for x ``[B, N, F]`` and c
    ``[B, M, F]``; fp32 or bf16 on one device, each lane's rows row-major
    (the lanes at any stride); an fp32 result. A CUDA tensor launches the
    kernel; a CPU tensor takes ``ref.pairwise_l2_ref``."""
    if not x.is_cuda:
        return ref.pairwise_l2_ref(x, c)
    c = _check(x, c)
    *lanes, n, f = x.shape
    return _launch(x, c, *plan_pairwise(lanes[0] if lanes else 1, n,
                                        c.shape[-2], f))


def divergence_sq(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """:func:`pairwise_l2` against one centroid (``g [1, F]``, ``[B, 1,
    F]`` lane by lane) on the slab plan of :func:`plan_divergence`: each
    row's ``[.., 1]`` result is the same bits at any number of rows."""
    if not x.is_cuda:
        return ref.pairwise_l2_ref(x, g)
    g = _check(x, g)
    if g.shape[-2] != 1:
        raise ValueError(f"divergence_sq: want one centroid; got "
                         f"{tuple(g.shape)}")
    *lanes, n, f = x.shape
    return _launch(x, g, *plan_kernel(lanes[0] if lanes else 1, n, 1,
                                      *plan_divergence(f)))


def _check(x, c) -> torch.Tensor:
    """The kernel's contract: shapes, dtype, device, layout, sizes. Returns
    c in fp32 (its M rows widened here; the kernel reads x as it is)."""
    if (x.dim() not in (2, 3) or c.dim() != x.dim()
            or x.shape[-1] != c.shape[-1] or x.shape[:-2] != c.shape[:-2]):
        raise ValueError(f"pairwise_l2: want x [N, F] and c [M, F], or "
                         f"[B, N, F] and [B, M, F]; got {tuple(x.shape)} "
                         f"and {tuple(c.shape)}")
    if x.dtype not in _SYMBOLS or c.dtype not in _SYMBOLS:
        raise TypeError(f"pairwise_l2: the kernel takes float32 or bfloat16; "
                        f"got {x.dtype} and {c.dtype}")
    if c.device != x.device:
        raise ValueError("pairwise_l2: x and c lie on different devices "
                         f"({x.device}, {c.device})")
    if not (_rows_contiguous(x) and _rows_contiguous(c)):
        raise ValueError("pairwise_l2: the kernel takes row-major rows")
    *lanes, n, f = x.shape
    b, m = (lanes[0] if lanes else 1), c.shape[-2]
    # rows are addressed in 64 bits (x may pass 2^31 elements); a row's
    # columns, the pairs and (in _launch) the (pair, slab) blocks in 32
    if max(f, b * n * m) >= 2 ** 31:
        raise ValueError(f"pairwise_l2: {tuple(x.shape)}x{tuple(c.shape)} "
                         "exceeds the kernel's 32-bit sizes")
    return c.to(torch.float32)


def _launch(x, c, kernel: str, slabs: int, width: int, rows: int):
    """``kernel`` of ``KERNELS`` over ``slabs`` slabs of ``width`` columns
    of F, ``rows`` rows of x a block (c in fp32)."""
    *lanes, n, f = x.shape
    b, m = (lanes[0] if lanes else 1), c.shape[-2]
    if b * n * m * slabs >= 2 ** 31:
        raise ValueError(f"pairwise_l2: {b * n * m} pairs of {slabs} slabs "
                         "exceed the kernel's 32-bit grid")
    out = torch.empty((*lanes, n, m), dtype=torch.float32, device=x.device)
    part = None
    if slabs > 1:
        part = torch.empty((b * n * m, slabs), dtype=torch.float32,
                           device=x.device)
    fn = load_function("pairwise_l2", _SYMBOLS[x.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    strides = (x.stride(0), c.stride(0)) if lanes else (0, 0)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), c.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), b, n, m, f,
                 *strides, slabs, width, rows, KERNELS.index(kernel), stream)
    if err:
        raise RuntimeError("pairwise_l2: kernel launch failed: "
                           + error_string("pairwise_l2", err))
    pairwise_l2.launches += 1
    pairwise_l2.centroid_walks += kernel == KERNELS[2]
    return out


#: kernel calls so far, and those of them on the centroid walk (plain
#: counts, reset by whoever reads them)
pairwise_l2.launches = 0
pairwise_l2.centroid_walks = 0
