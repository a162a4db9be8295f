"""Registered device-selection strategies (paper §IV, Algorithms 3-4, and
the compared baselines; ``repro.strategies.selectors``, host contract).
Thin adapters over ``repro_torch.core.selection``; each reads only what
it needs from the :class:`SelectionContext`. The channel-aware policies
compute their rates from the fleet in fp32 on the CPU, as the reference
does in ``jnp``."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.api.protocols import SelectionContext
from repro_torch.api.registry import SELECTORS, Strategy, StrategyError
from repro_torch.core.selection import (select_divergence, select_icas,
                                        select_kmeans_random, select_random,
                                        select_rra)
from repro_torch.core.wireless import (effective_arrays, fleet_arrays,
                                       rate_mbps)


def _require_clusters(ctx: SelectionContext, name: str):
    if ctx.clusters is None:
        raise StrategyError(
            f"selector {name!r} needs K-means clusters; run the initial "
            "round (Algorithm 2) first")
    return ctx.clusters


def _host_arrays(ctx: SelectionContext):
    """The fleet's interference-folded arrays, fp32 on the CPU."""
    return effective_arrays(fleet_arrays(ctx.fleet))


def _rate_at(arr, band_mhz: float) -> torch.Tensor:
    """Each device's rate [Mbit/s] at an equal band share ``band_mhz``."""
    return rate_mbps(torch.tensor(band_mhz, dtype=torch.float32), arr["J"])


@SELECTORS.register("random")
@dataclass(frozen=True)
class RandomSelector(Strategy):
    """FedAvg [31]: S uniform devices."""

    needs_rng = True
    needs_divergence = False

    def select(self, ctx: SelectionContext) -> np.ndarray:
        return select_random(ctx.rng, ctx.num_devices, ctx.devices_per_round)


@SELECTORS.register("kmeans_random")
@dataclass(frozen=True)
class KMeansRandomSelector(Strategy):
    """Algorithm 3: s random devices from each cluster."""

    needs_rng = True
    needs_divergence = False
    needs_clusters = True

    def select(self, ctx: SelectionContext) -> np.ndarray:
        return select_kmeans_random(
            ctx.rng, _require_clusters(ctx, self.registry_name),
            ctx.selected_per_cluster)


@SELECTORS.register("divergence")
@dataclass(frozen=True)
class DivergenceSelector(Strategy):
    """Algorithm 4 (ours): top-s weight divergence per cluster."""

    needs_rng = False
    needs_divergence = True
    needs_clusters = True

    def select(self, ctx: SelectionContext) -> np.ndarray:
        return select_divergence(ctx.divergences(),
                                 _require_clusters(ctx, self.registry_name),
                                 ctx.selected_per_cluster)


@SELECTORS.register("icas")
@dataclass(frozen=True)
class ICASSelector(Strategy):
    """ICAS [42]: importance × channel-rate blend, deterministic top-S."""

    beta: float = 0.5

    needs_rng = False
    needs_divergence = True

    def select(self, ctx: SelectionContext) -> np.ndarray:
        rates = _rate_at(_host_arrays(ctx),
                         ctx.bandwidth_mhz / ctx.num_devices).numpy()
        return select_icas(ctx.divergences(), rates, ctx.devices_per_round,
                           beta=self.beta)


@SELECTORS.register("stochastic-sched")
@dataclass(frozen=True)
class StochasticSchedSelector(Strategy):
    """Churn-aware stochastic scheduling (Perazzone et al., arXiv
    2201.07912): independent per-device participation probabilities
    proportional to energy headroom over per-round cost, normalized to an
    expected set size of ``devices_per_round``; never empty."""

    needs_rng = True
    needs_divergence = False

    def select(self, ctx: SelectionContext) -> np.ndarray:
        arr = _host_arrays(ctx)
        S = ctx.devices_per_round
        cost = ((arr["H"] / _rate_at(arr, ctx.bandwidth_mhz / S)).numpy()
                + arr["G"].numpy() * np.square(arr["f_max"].numpy()))
        ratio = arr["e_cons"].numpy() / np.maximum(cost, 1e-12)
        p = np.clip(S * ratio / max(float(ratio.sum()), 1e-12), 0.0, 1.0)
        mask = ctx.rng.random(ctx.num_devices) < p
        if not mask.any():
            mask[int(np.argmax(ratio))] = True
        return np.flatnonzero(mask)


@SELECTORS.register("rra")
@dataclass(frozen=True)
class RRASelector(Strategy):
    """RRA [39]: energy-efficiency participation thresholding; the selected
    set size varies per round (~``target_mean`` on average, §VI-C)."""

    target_mean: int = 45

    needs_rng = True
    needs_divergence = False

    def select(self, ctx: SelectionContext) -> np.ndarray:
        arr = _host_arrays(ctx)
        e_eq = (arr["H"] / _rate_at(arr, ctx.bandwidth_mhz
                                    / self.target_mean)).numpy()
        return select_rra(ctx.rng, e_eq, arr["e_cons"].numpy(),
                          target_mean=self.target_mean)
