"""Weight divergence — paper §IV-C, the selection signal of Algorithm 4.

d_n = ‖w_n − w_global‖₂ over ALL layers, as one row-norm reduction over
the ``[N, P]`` flat client plane (``repro_torch.kernels.ops``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def weight_divergence_flat(client_flat: torch.Tensor,
                           global_vec: torch.Tensor) -> torch.Tensor:
    """[N] divergences over the flat plane: client_flat [N, P], global [P]."""
    return ops.client_divergence(client_flat, global_vec)
