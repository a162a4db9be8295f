"""Registered spectrum-allocation strategies: SAO (Alg. 5, ours) and the
§VI-A baselines (``repro.strategies.allocators``). Each takes the
``fleet_arrays`` of the selected devices and the band B [MHz] and returns
an :class:`Allocation`, whose tensors stay on the fleet arrays' device
until the history reads them. ``mask`` marks the real lanes of a padded
selection.

Each also implements the traced contract
(``repro_torch.api.protocols.TracedAllocator``): ``allocate_traced(arr,
B, mask) -> (T, E, b, f)``, which ``allocate`` wraps. Inside a captured
round the solves run their eager bodies as part of the round's graph.
Arrays (and mask) of ``[B, S]`` carry a leading lane axis (a cohort's
seeds): ``T`` and ``E`` are then ``[B]``, one allocation a lane."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.api.protocols import Allocation
from repro_torch.api.registry import ALLOCATORS, Strategy, StrategyError
from repro_torch.core.baselines import (equal_bandwidth, fedl_lambda,
                                        tune_fedl_lambda)
from repro_torch.core.sao import _Q, solve_sao
from repro_torch.core.wireless import effective_arrays, masked_sum


@ALLOCATORS.register("sao")
@dataclass(frozen=True)
class SAOAllocator(Strategy):
    """Algorithm 5: per-device bandwidth and CPU frequency under
    per-device energy budgets; ``box_correct`` (``sao:box``) takes the KKT
    box correction beyond the paper."""

    box_correct: bool = False

    traceable = True

    def allocate(self, arr, B: float, mask=None) -> Allocation:
        return Allocation(*self.allocate_traced(arr, B, mask))

    def allocate_traced(self, arr, B: float, mask):
        # interference folds into J before the energy sum too: the rate the
        # solver allocated against is the degraded one
        arr = effective_arrays(arr)
        s = solve_sao(arr, B, mask=mask, box_correct=self.box_correct)
        e = arr["G"] * torch.square(s.f) + arr["H"] / _Q(s.b, arr["J"])
        return s.T, masked_sum(e, mask), s.b, s.f

    @classmethod
    def from_string(cls, arg):
        if arg in (None, ""):
            return cls()
        if arg in ("box", "box_correct"):
            return cls(box_correct=True)
        raise StrategyError(f"sao:{arg}: the only ':arg' is 'box' (KKT box "
                            "correction)")


@ALLOCATORS.register("equal")
@dataclass(frozen=True)
class EqualBandwidthAllocator(Strategy):
    """Baseline 1: b_n = B/S, fastest feasible frequency per device."""

    traceable = True

    def allocate(self, arr, B: float, mask=None) -> Allocation:
        return Allocation(*self.allocate_traced(arr, B, mask))

    def allocate_traced(self, arr, B: float, mask):
        r = equal_bandwidth(arr, B, mask=mask)
        return r.T, torch.sum(r.e, dim=-1), r.b, r.f


@ALLOCATORS.register("fedl")
@dataclass(frozen=True)
class FEDLAllocator(Strategy):
    """Baseline 2 — FEDL [27]: min Σe + λ·T without per-device energy
    constraints, at a fixed λ (``fedl:<λ>``)."""

    lam: float = 1.0

    traceable = True

    def allocate(self, arr, B: float, mask=None) -> Allocation:
        return Allocation(*self.allocate_traced(arr, B, mask))

    def allocate_traced(self, arr, B: float, mask):
        r = fedl_lambda(arr, B, self.lam, mask=mask)
        return r.T, masked_sum(r.e, mask), r.b, r.f


@ALLOCATORS.register("fedl_auto")
@dataclass(frozen=True)
class FEDLAutoAllocator(Strategy):
    """FEDL with the §VI-A λ protocol ('the device with the highest energy
    cost just meets its budget') tuned every round: ``iters`` bisection
    steps on λ (``fedl_auto:<iters>``), each a solve over an ``n_grid``
    T grid, then the solve at the tuned λ."""

    iters: int = 12
    n_grid: int = 60

    traceable = True

    def allocate(self, arr, B: float, mask=None) -> Allocation:
        return Allocation(*self.allocate_traced(arr, B, mask))

    def allocate_traced(self, arr, B: float, mask):
        arr = effective_arrays(arr)
        lam = tune_fedl_lambda(arr, B, mask=mask, iters=self.iters,
                               n_grid=self.n_grid)
        r = fedl_lambda(arr, B, lam, n_grid=self.n_grid, mask=mask)
        return r.T, masked_sum(r.e, mask), r.b, r.f
