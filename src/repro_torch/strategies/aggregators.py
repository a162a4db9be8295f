"""Server aggregation strategy: eq. (4) FedAvg on the flat plane
(``repro.strategies.aggregators.FedAvgAggregator``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import ops


@dataclass(frozen=True)
class FedAvgAggregator:
    """Eq. (4): the D_n-weighted mean of the participating client rows, as
    one ``ops.flat_aggregate`` row reduction. Stateless."""

    registry_name = "fedavg"

    def aggregate_flat(self, global_vec: torch.Tensor, rows: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
        return ops.flat_aggregate(rows, weights)
