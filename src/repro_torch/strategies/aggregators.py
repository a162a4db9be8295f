"""Registered server aggregation strategies: eq. (4) FedAvg, the
beyond-paper FedAvgM server momentum and FedBuff's buffered asynchronous
fold, on the flat plane (``repro.strategies.aggregators``).

All implement the flat contract the round body drives: ``aggregate_flat``
folds the round's ``[S, P]`` rows with one ``ops.flat_aggregate`` row
reduction (the hand-written kernel on the card); ``init_flat_state``
builds the server state carried in ``RoundState.opt_state`` (``None``, or
FedAvgM's ``[P]`` momentum); ``load_flat_state`` copies a finished carry
back into the host object, so the host loop continues from it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.api.registry import AGGREGATORS, Strategy, StrategyError
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


@AGGREGATORS.register("fedbuff")
@dataclass(frozen=True)
class FedBuffAggregator(Strategy):
    """FedBuff (Nguyen et al. 2022): buffered asynchronous aggregation,
    spelled ``fedbuff:M[:alpha]``. The buffer fires when ``m`` updates
    have landed, folding them with staleness-discounted weights ``w ∝ (1 +
    age)^(-alpha)``.

    ``async_capable`` routes a run to the buffered-asynchronous engine
    (``repro_torch.core.async_engine``), which discounts the weights with
    :meth:`staleness_weights` first; ``aggregate_flat`` is then FedAvg's
    one row reduction, so ``fedbuff:M:0`` with M at least the padded
    selection and no churn is the synchronous round bit for bit."""

    m: int = 10
    alpha: float = 0.0

    fuses_with_engine = False
    traceable = True
    async_capable = True

    def __post_init__(self):
        if self.m < 1:
            raise StrategyError(
                f"fedbuff buffer size must be >= 1 (got {self.m})")
        if self.alpha < 0:
            raise StrategyError(
                f"fedbuff staleness exponent must be >= 0 (got {self.alpha})")

    @classmethod
    def from_string(cls, arg):
        """``M[:alpha]`` (the registry splits ``fedbuff:M:alpha`` at its
        first colon)."""
        if arg is None or arg == "":
            return cls()
        m_s, _, alpha_s = arg.partition(":")
        try:
            m = int(m_s)
            alpha = float(alpha_s) if alpha_s else 0.0
        except ValueError:
            raise StrategyError(
                f"fedbuff:{arg}: expected 'M[:alpha]' with integer M and "
                "float alpha") from None
        return cls(m=m, alpha=alpha)

    @property
    def buffer_size(self) -> int:
        return self.m

    @property
    def staleness_alpha(self) -> float:
        return self.alpha

    def staleness_weights(self, age: torch.Tensor) -> torch.Tensor:
        """``(1 + age)^(-alpha)``; at ``alpha == 0`` ones, so no ``pow``
        touches the weights."""
        if self.alpha == 0.0:
            return torch.ones_like(age)
        return torch.pow(1.0 + age, -self.alpha)

    def init_flat_state(self, global_vec: torch.Tensor):
        return None

    def aggregate_flat(self, global_vec, rows, weights, opt_state=None):
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
