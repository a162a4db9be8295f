"""Registered device-selection strategies (paper §IV, Algorithms 3-4, and
the compared baselines; ``repro.strategies.selectors``). Thin adapters
over ``repro_torch.core.selection``; each reads only what it needs from
the :class:`SelectionContext`. The channel-aware policies compute their
rates from the fleet in fp32 on the CPU, as the reference does in
``jnp``.

Every one also implements the traced contract
(``repro_torch.api.protocols.TracedSelector``): ``select_traced`` over
fixed-size padded index sets (``repro_torch.strategies.traced``), which
the device-resident run (``repro_torch.core.engine.run_rounds``) calls.
The stochastic ones take their draw as an argument there: ``draw_kind``
names it (``"permutation"`` of N, or ``"uniform"``: N uniforms), so that
a draws object can make it (``repro_torch.core.draws``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.api.protocols import SelectionContext, TracedContext
from repro_torch.api.registry import SELECTORS, Strategy, StrategyError
from repro_torch.core.selection import (select_divergence, select_icas,
                                        select_kmeans_random, select_random,
                                        select_rra)
from repro_torch.core.wireless import effective_arrays, fleet_arrays
from repro_torch.strategies.traced import (rate_at, select_divergence_traced,
                                           select_icas_traced,
                                           select_kmeans_random_traced,
                                           select_random_traced,
                                           select_rra_traced,
                                           select_stochastic_sched_traced)


def _require_clusters(ctx: SelectionContext, name: str):
    if ctx.clusters is None:
        raise StrategyError(
            f"selector {name!r} needs K-means clusters; run the initial "
            "round (Algorithm 2) first")
    return ctx.clusters


def _host_arrays(ctx: SelectionContext):
    """The fleet's interference-folded arrays, fp32 on the CPU."""
    return effective_arrays(fleet_arrays(ctx.fleet))


@SELECTORS.register("random")
@dataclass(frozen=True)
class RandomSelector(Strategy):
    """FedAvg [31]: S uniform devices. Traced draw: a permutation of N."""

    traceable = True
    needs_rng = True
    needs_divergence = False
    draw_kind = "permutation"

    def select(self, ctx: SelectionContext) -> np.ndarray:
        return select_random(ctx.rng, ctx.num_devices, ctx.devices_per_round)

    def pad_size(self, ctx: TracedContext) -> int:
        return ctx.devices_per_round

    def select_traced(self, draw, divergences, labels, arr,
                      ctx: TracedContext):
        return select_random_traced(draw, num_devices=ctx.num_devices,
                                    S=ctx.devices_per_round)


@SELECTORS.register("kmeans_random")
@dataclass(frozen=True)
class KMeansRandomSelector(Strategy):
    """Algorithm 3: s random devices from each cluster. Traced draw: [N]
    uniforms."""

    traceable = True
    needs_rng = True
    needs_divergence = False
    needs_clusters = True
    draw_kind = "uniform"

    def select(self, ctx: SelectionContext) -> np.ndarray:
        return select_kmeans_random(
            ctx.rng, _require_clusters(ctx, self.registry_name),
            ctx.selected_per_cluster)

    def pad_size(self, ctx: TracedContext) -> int:
        return ctx.num_clusters * ctx.selected_per_cluster

    def select_traced(self, draw, divergences, labels, arr,
                      ctx: TracedContext):
        return select_kmeans_random_traced(
            draw, labels, num_clusters=ctx.num_clusters,
            s=ctx.selected_per_cluster, num_devices=ctx.num_devices)


@SELECTORS.register("divergence")
@dataclass(frozen=True)
class DivergenceSelector(Strategy):
    """Algorithm 4 (ours): top-s weight divergence per cluster."""

    traceable = True
    needs_rng = False
    needs_divergence = True
    needs_clusters = True

    def select(self, ctx: SelectionContext) -> np.ndarray:
        return select_divergence(ctx.divergences(),
                                 _require_clusters(ctx, self.registry_name),
                                 ctx.selected_per_cluster)

    def pad_size(self, ctx: TracedContext) -> int:
        return ctx.num_clusters * ctx.selected_per_cluster

    def select_traced(self, draw, divergences, labels, arr,
                      ctx: TracedContext):
        return select_divergence_traced(
            divergences, labels, num_clusters=ctx.num_clusters,
            s=ctx.selected_per_cluster, num_devices=ctx.num_devices,
            avail=arr.get("avail") if isinstance(arr, dict) else None)


@SELECTORS.register("icas")
@dataclass(frozen=True)
class ICASSelector(Strategy):
    """ICAS [42]: importance × channel-rate blend, deterministic top-S."""

    beta: float = 0.5

    traceable = True
    needs_rng = False
    needs_divergence = True

    def select(self, ctx: SelectionContext) -> np.ndarray:
        rates = rate_at(_host_arrays(ctx),
                         ctx.bandwidth_mhz / ctx.num_devices).numpy()
        return select_icas(ctx.divergences(), rates, ctx.devices_per_round,
                           beta=self.beta)

    def pad_size(self, ctx: TracedContext) -> int:
        return ctx.devices_per_round

    def select_traced(self, draw, divergences, labels, arr,
                      ctx: TracedContext):
        return select_icas_traced(
            divergences, arr, bandwidth_mhz=ctx.bandwidth_mhz,
            num_devices=ctx.num_devices, S=ctx.devices_per_round,
            beta=self.beta)


@SELECTORS.register("stochastic-sched")
@dataclass(frozen=True)
class StochasticSchedSelector(Strategy):
    """Churn-aware stochastic scheduling (Perazzone et al., arXiv
    2201.07912): independent per-device participation probabilities
    proportional to energy headroom over per-round cost, normalized to an
    expected set size of ``devices_per_round``; never empty. Traced draw:
    [N] uniforms."""

    traceable = True
    needs_rng = True
    needs_divergence = False
    draw_kind = "uniform"

    def pad_size(self, ctx: TracedContext) -> int:
        return ctx.num_devices          # the set size varies

    def select_traced(self, draw, divergences, labels, arr,
                      ctx: TracedContext):
        return select_stochastic_sched_traced(
            draw, arr, bandwidth_mhz=ctx.bandwidth_mhz,
            num_devices=ctx.num_devices, S=ctx.devices_per_round)

    def select(self, ctx: SelectionContext) -> np.ndarray:
        arr = _host_arrays(ctx)
        S = ctx.devices_per_round
        cost = ((arr["H"] / rate_at(arr, ctx.bandwidth_mhz / S)).numpy()
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
    set size varies per round (~``target_mean`` on average, §VI-C).
    Traced draw: [N] uniforms."""

    target_mean: int = 45

    traceable = True
    needs_rng = True
    needs_divergence = False
    draw_kind = "uniform"

    def pad_size(self, ctx: TracedContext) -> int:
        return ctx.num_devices          # the set size varies

    def select_traced(self, draw, divergences, labels, arr,
                      ctx: TracedContext):
        return select_rra_traced(
            draw, arr, bandwidth_mhz=ctx.bandwidth_mhz,
            num_devices=ctx.num_devices, target_mean=self.target_mean)

    def select(self, ctx: SelectionContext) -> np.ndarray:
        arr = _host_arrays(ctx)
        e_eq = (arr["H"] / rate_at(arr, ctx.bandwidth_mhz
                                    / self.target_mean)).numpy()
        return select_rra(ctx.rng, e_eq, arr["e_cons"].numpy(),
                          target_mean=self.target_mean)
