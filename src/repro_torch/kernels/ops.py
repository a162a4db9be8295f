"""Public wrappers around the hand-written kernels, with the reference's
guards and layouts (``repro/kernels/ops.py``).

Dispatch goes by the tensor's device only: a CUDA tensor launches the
hand kernel (or raises), a CPU tensor takes the plain PyTorch path, which
spells each op as the reference does off-TPU. The FL ops take an optional
leading lane axis (a cohort's seeds, where the reference ``vmap``s): one
launch serves every lane. On the card a bf16 plane or model goes to the
kernels' bf16 instances as it is (no widened copy of the plane); the CPU
paths widen, as the reference's off-TPU paths do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flat_aggregate import flat_aggregate as _flat_agg
from repro_torch.kernels.pairwise_l2 import divergence_sq as _divergence_sq
from repro_torch.kernels.pairwise_l2 import pairwise_l2 as _pairwise
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd


def kernel_dispatch(t: torch.Tensor) -> bool:
    """Would an op here on ``t`` take the kernel route? The reference
    asks the backend and a ``use_pallas`` flag; the port's rule is the
    tensor's device alone: a CUDA tensor launches the hand kernel (and an
    op that cannot launch it raises: nothing falls back to the plain
    version), any other tensor takes the plain PyTorch path."""
    return bool(t.is_cuda)


def pairwise_sq_dists(x, c):
    """[N, F] × [M, F] -> [N, M] squared L2 (K-means assignment); [B, N, F]
    × [B, M, F] -> [B, N, M] lane by lane.

    CUDA: the direct-form kernel, which reads a bf16 x as it is. CPU: the
    ‖x‖²+‖c‖²−2x·c expansion in fp32, clamped at zero so no caller sees a
    negative squared distance.
    """
    if x.is_cuda:
        return _pairwise(_kernel_float(x), _kernel_float(c))
    x = x.to(torch.float32)
    c = c.to(torch.float32)
    xn = torch.sum(torch.square(x), dim=-1, keepdim=True)
    cn = torch.sum(torch.square(c), dim=-1)[..., None, :]
    return torch.clamp(xn + cn - 2.0 * x @ c.transpose(-1, -2), min=0.0)


def flat_aggregate(flat, weights, *, mask=None, normalize: bool = True):
    """Masked weighted row-reduction over the flat client plane:
    ``[N, P] × [N] -> [P]`` — FedAvg aggregation (eq. 4) as one op; with a
    leading lane axis ``[B, N, P] × [B, N] -> [B, P]``.

    ``mask`` zeroes padding lanes' weights; ``normalize`` divides each
    lane's weights by ``max(Σw, 1e-12)`` over its own rows (an all-masked
    call gives zeros, not 0/0). Rows with ``w <= 0`` never reach the fold,
    so a NaN row at weight 0 cannot poison it.
    """
    w = weights.to(torch.float32)
    if mask is not None:
        w = torch.where(mask, w, torch.zeros_like(w))
    if normalize:
        w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    return _flat_agg(flat, w)


def _kernel_float(t):
    """``t`` as a kernel reads it: fp32 and bf16 as they are, any other
    float type widened to fp32."""
    return t if t.dtype in (torch.float32, torch.bfloat16) else t.to(
        torch.float32)


def client_divergence_sq(flat, gvec):
    """[N] squared weight divergences ‖flat_n − g‖₂² against the flat
    global row (``[B, N]`` lane by lane for a plane ``[B, N, P]`` and
    ``[B, P]``), in fp32. CUDA: the pairwise kernel with each lane's global
    row as its one centroid, on a slab plan of P alone, so a row's bits do
    not depend on the rows beside it in the call (the paged store reduces
    the plane in chunks); a bf16 plane is read as it is. CPU: the direct
    subtract-square-reduce in fp32."""
    if flat.is_cuda:
        g = gvec.to(torch.float32)[..., None, :]
        return _divergence_sq(_kernel_float(flat), g)[..., 0]
    sq = torch.square(flat.to(torch.float32)
                      - gvec.to(torch.float32)[..., None, :])
    if sq[..., 0].numel() == 1:
        # one output: torch would split its row over threads and add the
        # parts in another order; as one of two rows it keeps the order of
        # a row among many, so a row's bits do not depend on its call
        two = sq.expand(*sq.shape[:-2], 2, sq.shape[-1])
        return torch.sum(two, dim=-1)[..., :1]
    return torch.sum(sq, dim=-1)


def client_divergence(flat, gvec):
    """[N] weight divergences ‖flat_n − g‖₂ against the flat global row —
    §IV-C's selection signal; ``[B, N]`` for a plane ``[B, N, P]`` against
    one global row a lane ``[B, P]``: the root of
    :func:`client_divergence_sq`."""
    return torch.sqrt(client_divergence_sq(flat, gvec))


def chunked_client_divergence(rows, gvec, *, chunk_size=None):
    """Streaming form of :func:`client_divergence` for the paged client
    store: ``rows`` (an array or an iterable of ``[c, P]`` blocks, e.g.
    ``PagedStore.iter_chunks()``) one chunk at a time, each row's bits as
    in one call. A host ``[N]`` fp32 array."""
    from repro_torch.kernels.chunked import chunked_client_divergence as impl
    return impl(rows, gvec, chunk_size=chunk_size)


def chunked_pairwise(rows, centroids, *, chunk_size=None):
    """Streaming form of :func:`pairwise_sq_dists` over row chunks —
    K-means assignment against a cold store without the ``[N, P]`` plane.
    A host ``[N, M]`` fp32 array."""
    from repro_torch.kernels.chunked import chunked_pairwise as impl
    return impl(rows, centroids, chunk_size=chunk_size)


def attention(q, k, v, *, causal: bool = True, window=None):
    """GQA attention. q: [B, S, H, D]; k, v: [B, S, K, D] -> [B, S, H, D].

    CUDA: the flash-attention kernel, which reads KV head ``h // (H/K)``.
    CPU: the plain dense version with the kernel's masking and clamp."""
    return _flash(q, k, v, causal=causal, window=window)


def ssd(x, a, b, c, *, chunk: int = 256, n_groups: int = 1):
    """Mamba2 SSD. x: [B, S, H, P]; a: [B, S, H]; b, c: [B, S, G, N].

    Returns (y: [B, S, H, P], state: [B, H, P, N]). CUDA: the chunked scan
    kernel, which reads group ``h // (H/G)``. CPU: the token-by-token
    recurrence."""
    if b.shape[2] != n_groups or c.shape[2] != n_groups:
        raise ValueError(f"ssd: b/c carry {b.shape[2]} groups; "
                         f"n_groups={n_groups}")
    return _ssd(x, a, b, c, chunk=chunk)
