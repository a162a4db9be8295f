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
    one ``ops.flat_aggregate`` row reduction. Stateless: its server state
    (``RoundState.opt_state``) is ``None``."""

    traceable = True

    def init_flat_state(self, global_vec: torch.Tensor):
        return None

    def aggregate_flat(self, global_vec: torch.Tensor, rows: torch.Tensor,
                       weights: torch.Tensor, opt_state=None):
        """``(new global row, new server state)``: rows ``[S, P]`` and
        weights ``[S]`` give ``[P]``; with a leading lane axis (``[B, S,
        P]``, ``[B, S]``) one global row a lane, ``[B, P]``."""
        return ops.flat_aggregate(rows, weights), opt_state

    def load_flat_state(self, opt_state, spec) -> None:
        pass
