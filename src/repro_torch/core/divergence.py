"""Weight divergence — paper §IV-C, the selection signal of Algorithm 4.

d_n = ‖w_n − w_global‖₂ over ALL layers, as one row-norm reduction over
the ``[N, P]`` flat client plane (``repro_torch.kernels.ops``).
:func:`weight_divergence` keeps the stacked form for callers that hold
``{name: [N, ...]}`` client leaves.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.kernels import ops


def weight_divergence(stacked_client_params: Mapping[str, torch.Tensor],
                      global_params: Mapping[str, torch.Tensor]
                      ) -> torch.Tensor:
    """[N] distances between each client's leaves (stacked on a leading
    client axis) and the global model's, summed leaf by leaf."""
    total = 0.0
    for name, cl in stacked_client_params.items():
        diff = (cl.to(torch.float32)
                - global_params[name].to(torch.float32)[None])
        total = total + torch.sum(torch.square(diff).reshape(
            diff.shape[0], -1), dim=1)
    return torch.sqrt(total)


def weight_divergence_flat(client_flat: torch.Tensor,
                           global_vec: torch.Tensor) -> torch.Tensor:
    """[N] divergences over the flat plane: client_flat [N, P], global [P]."""
    return ops.client_divergence(client_flat, global_vec)


def pairwise_divergence_matrix(features: torch.Tensor) -> torch.Tensor:
    """[N, N] Euclidean distance matrix (Fig. 4's visualization)."""
    return torch.sqrt(ops.pairwise_sq_dists(features, features))
