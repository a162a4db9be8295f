"""Plain PyTorch versions of the hand-written kernels (the correctness
ground truth). Written in the most naive correct form, so a kernel test
compares two independent implementations; a kernel wrapper takes these
for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch


def pairwise_l2_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances. x: [N, F]; c: [M, F] -> [N, M] fp32.
    The direct difference form, O(N·M·F) memory."""
    diff = x.to(torch.float32)[:, None, :] - c.to(torch.float32)[None, :, :]
    return torch.sum(torch.square(diff), dim=-1)


def flat_aggregate_ref(flat: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Weighted row sum over the flat client plane: [N, P] × [N] -> [P] fp32,
    as an elementwise multiply + axis-0 reduce (not a dot)."""
    w = weights.to(torch.float32)
    return torch.sum(flat.to(torch.float32) * w[:, None], dim=0)
