"""Registered server aggregation strategies: eq. (4) FedAvg and the
beyond-paper FedAvgM server momentum, on the flat plane
(``repro.strategies.aggregators``).

Both implement the flat contract the round body drives: ``aggregate_flat``
folds the round's ``[S, P]`` rows with one ``ops.flat_aggregate`` row
reduction (the hand-written kernel on the card); ``init_flat_state``
builds the server state carried in ``RoundState.opt_state`` (``None``, or
FedAvgM's ``[P]`` momentum); ``load_flat_state`` copies a finished carry
back into the host object, so the host loop continues from it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.api.registry import AGGREGATORS, Strategy
from repro_torch.core.algorithms import ServerMomentum
from repro_torch.kernels import ops
from repro_torch.utils.trees import (flatten_vector, stack_flatten_spec,
                                     unflatten_vector)


def weighted_mean_stacked(stacked, weights):
    """Eq. (4) over a stacked client axis: ``{name: [S, ...]}`` and ``[S]``
    weights give ``{name: [...]}`` (the reference's
    ``tree_weighted_mean_stacked``)."""
    w = weights.to(torch.float32)
    norm = w / torch.sum(w)
    return {k: torch.sum(v.to(torch.float32)
                         * norm.reshape((-1,) + (1,) * (v.dim() - 1)),
                         dim=0).to(v.dtype)
            for k, v in stacked.items()}


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

    def reset(self) -> None:
        pass


@AGGREGATORS.register("fedavgm")
@dataclass
class FedAvgMAggregator(Strategy):
    """FedAvgM (Hsu et al. 2019): momentum over the server pseudo-gradient,
    v ← β·v + (w − agg), w ← w − lr·v. Spelled ``fedavgm:<β>``. The host
    object keeps the momentum between runs (``ServerMomentum``)."""

    beta: float = 0.9
    lr: float = 1.0

    traceable = True

    def __post_init__(self):
        self._opt = ServerMomentum(self.beta, self.lr)

    def aggregate(self, global_params, stacked_params, weights):
        """The host form over ``{name: tensor}`` models."""
        agg = weighted_mean_stacked(stacked_params, weights)
        return self._opt.step(global_params, agg)

    def reset(self):
        self._opt = ServerMomentum(self.beta, self.lr)

    def init_flat_state(self, global_vec: torch.Tensor):
        """The momentum as a flat row like ``global_vec`` (``[P]``, or
        ``[B, P]`` a lane each): the host's (continuing its momentum), or
        zeros (β·0 + Δ is Δ, the host's first step)."""
        v = self._opt.v
        if v is None:
            return torch.zeros_like(global_vec)
        row = flatten_vector(stack_flatten_spec(v), v)
        return row.to(global_vec.device).expand_as(global_vec).clone()

    def aggregate_flat(self, global_vec, rows, weights, opt_state):
        agg = ops.flat_aggregate(rows, weights)
        v = self.beta * opt_state + (global_vec - agg)  # pseudo-gradient
        return global_vec - self.lr * v, v

    def load_flat_state(self, opt_state, spec) -> None:
        self._opt.v = unflatten_vector(spec, opt_state.clone())
