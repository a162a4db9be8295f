"""Public wrappers around the hand-written kernels, with the reference's
guards and layouts (``repro/kernels/ops.py``).

Dispatch goes by the tensor's device only: a CUDA tensor launches the
hand kernel (or raises), a CPU tensor takes the plain PyTorch path, which
spells each op as the reference does off-TPU. The FL ops take an optional
leading lane axis (a cohort's seeds, where the reference ``vmap``s): one
launch serves every lane.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flat_aggregate import flat_aggregate as _flat_agg
from repro_torch.kernels.pairwise_l2 import pairwise_l2 as _pairwise
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd


def pairwise_sq_dists(x, c):
    """[N, F] × [M, F] -> [N, M] squared L2 (K-means assignment); [B, N, F]
    × [B, M, F] -> [B, N, M] lane by lane.

    CUDA: the direct-form kernel. CPU: the ‖x‖²+‖c‖²−2x·c expansion,
    clamped at zero so no caller sees a negative squared distance.
    """
    x = x.to(torch.float32)
    c = c.to(torch.float32)
    if x.is_cuda:
        return _pairwise(x, c)
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


def client_divergence(flat, gvec):
    """[N] weight divergences ‖flat_n − g‖₂ against the flat global row —
    §IV-C's selection signal; ``[B, N]`` for a plane ``[B, N, P]`` against
    one global row a lane ``[B, P]``. CUDA: the pairwise kernel with each
    lane's global row as its one centroid. CPU: the direct
    subtract-square-reduce."""
    if flat.is_cuda:
        g = gvec.to(torch.float32)[..., None, :]
        return torch.sqrt(_pairwise(flat.to(torch.float32), g)[..., 0])
    diff = flat.to(torch.float32) - gvec.to(torch.float32)[..., None, :]
    return torch.sqrt(torch.sum(torch.square(diff), dim=-1))


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
