"""Spectrum allocation strategy: SAO, Algorithm 5
(``repro.strategies.allocators.SAOAllocator``). It takes the
``fleet_arrays`` of the selected devices and the band B [MHz] and returns
an :class:`Allocation`, whose tensors stay on the fleet arrays' device
until the history reads them."""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.core.sao import _Q, solve_sao
from repro_torch.core.wireless import effective_arrays


class Allocation(NamedTuple):
    """One round's spectrum allocation (eqs. 10-11)."""
    T: torch.Tensor            # round delay T_k [s]
    E: torch.Tensor            # round energy E_k [J]
    b: torch.Tensor            # per-device bandwidth [MHz]
    f: torch.Tensor            # per-device CPU frequency [GHz]


@dataclass(frozen=True)
class SAOAllocator:
    """Algorithm 5: per-device bandwidth and CPU frequency under
    per-device energy budgets."""

    registry_name = "sao"

    def allocate(self, arr, B: float, mask=None) -> Allocation:
        # interference folds into J before the energy sum too: the rate the
        # solver allocated against is the degraded one
        arr = effective_arrays(arr)
        s = solve_sao(arr, B, mask=mask)
        e = arr["G"] * torch.square(s.f) + arr["H"] / _Q(s.b, arr["J"])
        if mask is not None:
            e = torch.where(mask, e, torch.zeros_like(e))
        return Allocation(T=s.T, E=torch.sum(e), b=s.b, f=s.f)
