"""Streaming chunked reductions over the cold half of the client store
(``repro.kernels.chunked``).

The paged client store (``repro_torch.core.store``) keeps O(K·P + chunk·P)
resident; these drivers run the plane's row reductions
(``ops.client_divergence``, ``ops.pairwise_sq_dists`` — the
``pairwise_l2`` kernel on the card) a chunk at a time and stream each
chunk's per-row results to the host, so a reduction never holds more than
one chunk.

The divergence is ROW-INDEPENDENT: row n's fp32 result is the same bits
whether it arrives in one ``[N, P]`` call or in ``ceil(N / chunk)``
block calls (on the card the one-centroid call's slab plan depends on P
alone, ``pairwise_l2.plan_divergence``), which the paged ≡ dense pins
rest on. The pairwise distances of a chunk agree with one call to fp32
accumulation order (a K-means call's slab plan, and the CPU's product,
depend on the rows in the call).

Inputs are one array or tensor (chunked here) or an iterable of ``[c_i,
P]`` blocks (the paged store's ``iter_chunks``, which never holds the
plane).
"""
from __future__ import annotations

from typing import Iterable, Iterator, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ops

DEFAULT_CHUNK_BYTES = 64 << 20     # ~64 MB of fp32 rows per resident chunk

Blocks = Union[np.ndarray, torch.Tensor, Iterable[np.ndarray]]


def default_chunk_size(row_size: int, *, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                       lo: int = 64, hi: int = 8192) -> int:
    """Rows per chunk so a resident fp32 block stays ~``chunk_bytes``."""
    rows = chunk_bytes // max(4 * int(row_size), 1)
    return int(min(hi, max(lo, rows)))


def iter_blocks(rows: Blocks, chunk_size: int) -> Iterator:
    """``[<= chunk_size, P]`` blocks of an array or tensor, or the blocks of
    an iterable as they come (re-chunking is the producer's business)."""
    if isinstance(rows, (np.ndarray, torch.Tensor)):
        for start in range(0, rows.shape[0], chunk_size):
            yield rows[start:start + chunk_size]
    else:
        yield from rows


def _on(block, device) -> torch.Tensor:
    """``block`` as row-major fp32 on ``device`` (one host-to-device
    copy)."""
    return torch.as_tensor(block, dtype=torch.float32).contiguous().to(
        device)


def chunked_client_divergence(rows: Blocks, gvec, *,
                              chunk_size: int | None = None) -> np.ndarray:
    """‖row_n − g‖₂ for every row, streamed a chunk at a time to the host
    on ``gvec``'s device: the bits of ``ops.client_divergence(rows, gvec)``
    on the whole input. A host ``[N]`` fp32 array."""
    gvec = torch.as_tensor(gvec, dtype=torch.float32)
    if chunk_size is None:
        chunk_size = default_chunk_size(gvec.shape[0])
    out = [ops.client_divergence(_on(b, gvec.device), gvec).cpu().numpy()
           for b in iter_blocks(rows, chunk_size)]
    if not out:
        return np.zeros((0,), np.float32)
    return np.concatenate(out)


def chunked_pairwise(rows: Blocks, centroids, *,
                     chunk_size: int | None = None) -> np.ndarray:
    """``[N, P] × [M, P] -> [N, M]`` squared L2, streamed over row chunks
    on ``centroids``' device. A single chunk is one
    ``ops.pairwise_sq_dists`` call; across chunks the reduction stays per
    (row, centroid) pair but agrees with one call to fp32 accumulation
    order, not bitwise. A host ``[N, M]`` fp32 array."""
    centroids = torch.as_tensor(centroids, dtype=torch.float32)
    if chunk_size is None:
        chunk_size = default_chunk_size(centroids.shape[-1])
    out = [ops.pairwise_sq_dists(_on(b, centroids.device),
                                 centroids).cpu().numpy()
           for b in iter_blocks(rows, chunk_size)]
    if not out:
        return np.zeros((0, centroids.shape[0]), np.float32)
    return np.concatenate(out, axis=0)


def _wsum_chunk(block: torch.Tensor, weights: torch.Tensor):
    """One block's ``(Σ_n w_n x_n [P], Σ_n w_n)``, a plain product (the
    reference's ``block.T @ w`` lies outside any Pallas kernel)."""
    w = weights.to(torch.float32)
    return torch.mv(block.to(torch.float32).T, w), torch.sum(w)


def streaming_weighted_mean(blocks: Iterable[Tuple[object, object]],
                            row_size: int) -> np.ndarray:
    """The eq.-(4) weighted mean over ``(rows, weights)`` blocks (host
    arrays or tensors on one device, where each block's sums run),
    holding one block at a time: ``Σ w_n x_n / Σ w_n`` accumulated in fp32
    on the host. A host ``[P]`` fp32 array.

    Not the bits of one ``ops.flat_aggregate`` call: the sum splits at the
    block boundaries and divides once at the end. The paged driver takes
    it only for an initial round in several waves, where no dense pin
    exists."""
    acc = np.zeros((row_size,), np.float32)
    wsum = 0.0
    for rows, weights in blocks:
        rows = torch.as_tensor(rows, dtype=torch.float32)
        s, w = _wsum_chunk(rows, torch.as_tensor(weights).to(rows.device))
        acc += s.cpu().numpy()
        wsum += float(w)
    return acc / max(wsum, 1e-12)
