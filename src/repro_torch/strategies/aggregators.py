"""Registered server aggregation strategy: eq. (4) FedAvg on the flat plane
(``repro.strategies.aggregators.FedAvgAggregator``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.api.registry import AGGREGATORS, Strategy
from repro_torch.kernels import ops


@AGGREGATORS.register("fedavg")
@dataclass(frozen=True)
class FedAvgAggregator(Strategy):
    """Eq. (4): the D_n-weighted mean of the participating client rows, as
    one ``ops.flat_aggregate`` row reduction. Stateless."""

    def aggregate_flat(self, global_vec: torch.Tensor, rows: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
        return ops.flat_aggregate(rows, weights)
