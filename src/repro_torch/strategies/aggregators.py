"""Registered server aggregation strategies: eq. (4) FedAvg, the
beyond-paper FedAvgM server momentum, FedBuff's buffered asynchronous
fold and the robust folds ``trimmed:f`` and ``clipnorm:c``, on the flat
plane (``repro.strategies.aggregators``).

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
from repro_torch.utils.trees import (flatten_stacked, flatten_vector,
                                     stack_flatten_spec, unflatten_vector)


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


class _FlatRobustMixin:
    """The host plumbing the robust folds share: stateless on the server,
    and the stacked ``{name: [S, ...]}`` contract served through the flat
    fold, so the host and the round body share one implementation."""

    fuses_with_engine = False
    traceable = True

    def reset(self) -> None:
        pass

    def init_flat_state(self, global_vec: torch.Tensor):
        return None

    def load_flat_state(self, opt_state, spec) -> None:
        pass

    def aggregate(self, global_params, stacked_params, weights):
        """The host form over ``{name: tensor}`` models."""
        spec = stack_flatten_spec(global_params)
        gvec = flatten_vector(spec, global_params)
        rows = flatten_stacked(spec, stacked_params)
        vec, _ = self.aggregate_flat(gvec, rows,
                                     weights.to(torch.float32), None)
        return unflatten_vector(spec, vec)


@AGGREGATORS.register("trimmed")
@dataclass
class TrimmedMeanAggregator(_FlatRobustMixin, Strategy):
    """Coordinate-wise trimmed mean (Yin et al. 2018), ``trimmed:f`` with
    ``f ∈ [0, 0.5)``: per coordinate, sort the participating rows, drop
    the ``⌊f·k⌋`` smallest and largest of the ``k`` participants and
    average the rest UNWEIGHTED (rank-based: D_n weighting does not
    compose with it). A byzantine row that negates and amplifies lands in
    the trimmed tails coordinate by coordinate.

    Zero-weight lanes (padding, lost and guarded uploads) sort to ``+inf``
    above every real value, so ranks ``[0, k)`` are the participants;
    ``f = 0`` is the unweighted mean of the participants. A sort, not a
    kernel: the reference runs it as ``jnp.sort`` outside any Pallas
    kernel. Rows ``[S, P]`` or lanes ``[B, S, P]``."""

    f: float = 0.1

    def __post_init__(self):
        if not 0.0 <= self.f < 0.5:
            raise StrategyError(
                f"trimmed-mean fraction must lie in [0, 0.5); got {self.f}")

    def aggregate_flat(self, global_vec, rows, weights, opt_state=None):
        valid = weights.to(torch.float32) > 0.0                # [.., S]
        k = torch.sum(valid.to(torch.int64), dim=-1, keepdim=True)
        t = torch.floor(self.f * k.to(torch.float32)).to(torch.int64)
        inf = torch.full((), float("inf"), device=rows.device)
        srt = torch.sort(torch.where(valid[..., None], rows, inf),
                         dim=-2).values
        ranks = torch.arange(rows.shape[-2], device=rows.device)
        keep = (ranks >= t) & (ranks < k - t)                  # [.., S]
        total = torch.sum(torch.where(keep[..., None], srt,
                                      torch.zeros_like(inf)), dim=-2)
        denom = torch.clamp(k - 2 * t, min=1).to(torch.float32)
        return total / denom, opt_state


@AGGREGATORS.register("clipnorm")
@dataclass
class ClipNormAggregator(_FlatRobustMixin, Strategy):
    """Eq. (4) with per-client update-norm clipping, ``clipnorm:c`` (``c >
    0``, in flat-plane L2 units): each row's delta from the global row is
    scaled to ``‖w_n − g‖ ≤ c`` before the weighted mean, which bounds any
    one client's pull and keeps the D_n weighting. The clipped rows fold
    through ``ops.flat_aggregate`` (the hand kernel on the card); a NaN
    row stays NaN through the clip, and its weight, zeroed by the
    non-finite guard before the fold, keeps it out."""

    c: float = 1.0

    def __post_init__(self):
        if not self.c > 0.0:
            raise StrategyError(
                f"clipnorm radius must be > 0; got {self.c}")

    def aggregate_flat(self, global_vec, rows, weights, opt_state=None):
        g = global_vec[..., None, :]
        delta = rows - g
        nrm = torch.sqrt(torch.sum(torch.square(delta), dim=-1,
                                   keepdim=True))
        scale = torch.clamp(self.c / torch.clamp(nrm, min=1e-12), max=1.0)
        clipped = g + delta * scale
        return ops.flat_aggregate(clipped, weights), opt_state
