"""Declarative physical-layer scenarios — the paper's §III-B system model
(eqs (5)–(11)) as a frozen, JSON-round-trippable spec
(``repro.api.scenario``).

    FleetSpec                       # topology: cells × device distributions
      └── CellSpec × C              # per-cell geometry, counts, power/energy
    CHANNELS registry               # static | rayleigh-block | gauss-markov:
                                    # <rho> | multicell-interference |
                                    # multicell-dynamic | @register_channel
    build_fleet(spec, seed)         # → Fleet (host numpy, byte-identical to
                                    #   the reference's build)

A ``FleetSpec`` is the ``fleet`` field of ``ExperimentSpec``:

    spec = ExperimentSpec(fleet=multicell_fleet_spec(
        2, channel={"name": "multicell-dynamic", "params": {"rho": 0.9}}))
    build_cohort(spec).run()        # (seeds × cells) lanes, ONE round

The fleet draw is numpy on the host, as in the reference: cell ``i``
draws from ``default_rng(seed + i·CELL_SEED_STRIDE)``, so the single-cell
``FleetSpec()`` reproduces ``sample_fleet`` bit for bit. The channels'
per-round fading runs on the device inside the round body
(``repro_torch.core.engine``) and takes its CN(0,1) draws as arguments
(``TorchDraws.channel_init``/``channel_step``): the same AR(1) arithmetic
on the reference's draws gives the reference's gains.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.api.registry import (CHANNELS, Strategy, StrategyError,
                                      register_channel)
from repro_torch.core.wireless import (CELL_RADIUS_KM, DEFAULT_ALPHA,
                                       DEFAULT_B_MHZ, DEFAULT_CYCLES_RANGE,
                                       DEFAULT_E_CONS_RANGE,
                                       DEFAULT_F_MAX_GHZ, DEFAULT_F_MIN_GHZ,
                                       DEFAULT_LOCAL_ITERS, DEFAULT_P_DBM,
                                       DEFAULT_SAMPLES_RANGE, DEFAULT_Z_MBIT,
                                       NOISE_DBM_PER_HZ, PATHLOSS_DB,
                                       SHADOW_STD_DB, Fleet, dbm_to_watt)

FLEET_SPEC_VERSION = 1

# decorrelates per-cell streams (fleet draws here, data partitions in
# api.build) while cell 0 keeps the single-cell stream; consecutive
# cohort seeds never land on another cell's stream
CELL_SEED_STRIDE = 7919

__all__ = ["CellSpec", "FleetSpec", "build_fleet", "CHANNELS",
           "register_channel", "StaticChannel", "RayleighBlockChannel",
           "GaussMarkovChannel", "MulticellInterferenceChannel",
           "MulticellDynamicChannel", "multicell_fleet_spec",
           "population_fleet_spec", "CELL_SEED_STRIDE"]


# ---------------------------------------------------------------------------
# channel models
# ---------------------------------------------------------------------------


def _largescale_gains(rng, d_km, shadow_db):
    """3GPP path loss + lognormal shadowing: the large-scale draw every
    built-in shares, so the serving links draw alike under every model."""
    pl_db = PATHLOSS_DB(d_km) + rng.normal(0.0, shadow_db, np.shape(d_km))
    return 10.0 ** (-pl_db / 10.0)


def _gm_init(h0, arr):
    """The fading state h_0: the CN(0,1) draw itself, ``J.shape + (2,)``
    real (re, im) fp32 (``TorchDraws.channel_init``)."""
    if tuple(h0.shape) != tuple(arr["J"].shape) + (2,):
        raise ValueError(f"channel draw is {tuple(h0.shape)}; want J's "
                         f"shape + (2,) = {tuple(arr['J'].shape) + (2,)}")
    return h0


def _gm_step(rho, floor, w, h, arr):
    """One AR(1) step h_t = ρ·h_{t−1} + √(1−ρ²)·w_t (``w`` the round's
    CN(0,1) draw, ``TorchDraws.channel_step``); the round's power gain
    |h_t|² scales J, floored at ``floor``. Shared by ``gauss-markov`` and
    ``rayleigh-block`` (its ρ = 0 case), which makes the two equal bit for
    bit. Returns ``(h_t, arr with the faded J)``."""
    h = rho * h + math.sqrt(max(1.0 - rho * rho, 0.0)) * w
    gain = torch.sum(torch.square(h), dim=-1)
    out = dict(arr)
    out["J"] = arr["J"] * torch.clamp(gain, min=floor)
    return h, out


@register_channel("static")
@dataclass(frozen=True)
class StaticChannel(Strategy):
    """The paper's §VI channel: path loss + lognormal shadowing drawn once
    at fleet build time, constant over rounds (``shadow_db = 0``: no
    shadowing)."""

    shadow_db: float = SHADOW_STD_DB

    traceable = True
    needs_rng = False
    stateful = False

    def sample_gains(self, rng, d_km):
        return _largescale_gains(rng, d_km, self.shadow_db)

    def apply_traced(self, w, arr):
        return arr


@register_channel("gauss-markov")
@dataclass(frozen=True)
class GaussMarkovChannel(Strategy):
    """First-order Gauss-Markov time-correlated fading: h_t = ρ·h_{t−1} +
    √(1−ρ²)·w_t with w, h_0 ~ CN(0,1), so |h_t|² is unit-mean exponential
    at every lag with round-to-round correlation ρ². The state rides the
    round's carry (``RoundState.channel``). ``rho = 0`` is block Rayleigh;
    ``floor`` clamps deep fades. Spelled ``gauss-markov:<rho>``."""

    rho: float = 0.9
    floor: float = 1e-3
    shadow_db: float = SHADOW_STD_DB

    traceable = True
    needs_rng = True
    stateful = True

    def __post_init__(self):
        if not 0.0 <= self.rho <= 1.0:
            raise ValueError(f"gauss-markov rho must be in [0, 1]; "
                             f"got {self.rho}")

    def sample_gains(self, rng, d_km):
        return _largescale_gains(rng, d_km, self.shadow_db)

    def init_state(self, h0, arr):
        return _gm_init(h0, arr)

    def step_traced(self, w, state, arr):
        return _gm_step(self.rho, self.floor, w, state, arr)

    def apply_traced(self, w, arr):
        """A memoryless (ρ = 0) draw, for callers outside the round
        body."""
        return _gm_step(0.0, self.floor, w, 0.0, arr)[1]


@register_channel("rayleigh-block")
@dataclass(frozen=True)
class RayleighBlockChannel(GaussMarkovChannel):
    """Block Rayleigh fading, redrawn every round: the ρ = 0 case of
    :class:`GaussMarkovChannel` (the same draws and arithmetic). Spelled
    ``rayleigh-block:<floor>``."""

    rho: float = dataclasses.field(default=0.0, init=False)
    floor: float = 1e-3
    shadow_db: float = SHADOW_STD_DB

    @classmethod
    def from_string(cls, arg):
        if arg in (None, ""):
            return cls()
        try:
            return cls(floor=float(arg))
        except ValueError:
            raise StrategyError(
                f"rayleigh-block:{arg}: expected a number for "
                "'floor'") from None


@register_channel("multicell-interference")
@dataclass(frozen=True)
class MulticellInterferenceChannel(Strategy):
    """Multi-cell uplink with build-time interference: every cell reuses
    the band, and BS c hears ``I_c = load · Σ_{m≠c} mean_{k∈m}(h_{k→c}·p_k)
    / (B·1e6)`` [W/Hz] (cross links: path loss only), folded into the rate
    as ``inr = I/N0``. Spelled ``multicell-interference:<load>``."""

    load: float = 1.0
    shadow_db: float = SHADOW_STD_DB

    traceable = True
    needs_rng = False
    stateful = False

    def sample_gains(self, rng, d_km):
        return _largescale_gains(rng, d_km, self.shadow_db)

    def apply_traced(self, w, arr):
        return arr

    def cross_cell_inr(self, pos_km, p_watt, cell_ids, centers_km,
                       bandwidth_mhz: float, N0: float) -> np.ndarray:
        """Per-device ``I/N0`` at its serving BS (one value a cell)."""
        cell_ids = np.asarray(cell_ids)
        num_cells = len(centers_km)
        inr = np.zeros(len(cell_ids))
        if num_cells < 2 or self.load <= 0.0:
            return inr
        for c in range(num_cells):
            psd = 0.0
            for m in range(num_cells):
                if m == c:
                    continue
                k = np.flatnonzero(cell_ids == m)
                d = np.hypot(pos_km[k, 0] - centers_km[c][0],
                             pos_km[k, 1] - centers_km[c][1])
                g = 10.0 ** (-PATHLOSS_DB(d) / 10.0)
                psd += float(np.mean(g * p_watt[k])) / (bandwidth_mhz * 1e6)
            inr[cell_ids == c] = self.load * psd / N0
        return inr


@register_channel("multicell-dynamic")
@dataclass(frozen=True)
class MulticellDynamicChannel(Strategy):
    """Multi-cell uplink with selection-driven interference: each round,
    BS c's ``inr`` is the sum of the cross gains of the devices the OTHER
    cells selected that round, reduced inside the round body (a seed's
    cells are lanes of one captured round). Selection sees the gains
    before interference (causal scheduling). ``build_fleet`` precomputes
    the cross-gain matrix (:meth:`cross_gain_matrix`). ``rho`` (None: off)
    adds Gauss-Markov fading on each device's serving link. Spelled
    ``multicell-dynamic:<load>``."""

    load: float = 1.0
    shadow_db: float = SHADOW_STD_DB
    rho: Optional[float] = None
    floor: float = 1e-3

    traceable = True
    dynamic = True

    def __post_init__(self):
        if self.rho is not None and not 0.0 <= self.rho <= 1.0:
            raise ValueError(f"multicell-dynamic rho must be in [0, 1]; "
                             f"got {self.rho}")

    @property
    def needs_rng(self):
        return self.rho is not None

    @property
    def stateful(self):
        return self.rho is not None

    def sample_gains(self, rng, d_km):
        return _largescale_gains(rng, d_km, self.shadow_db)

    def apply_traced(self, w, arr):
        return arr

    def init_state(self, h0, arr):
        return _gm_init(h0, arr)

    def step_traced(self, w, state, arr):
        return _gm_step(self.rho, self.floor, w, state, arr)

    def cross_gain_matrix(self, pos_km, p_watt, cell_ids, centers_km,
                          bandwidth_mhz: float, N0: float) -> np.ndarray:
        """``X[n, c]``: the inr device ``n`` adds at BS ``c`` when it
        transmits, ``load · g_{n→c} · p_n / (B·1e6 · N0)``; the own-cell
        column is 0."""
        cell_ids = np.asarray(cell_ids)
        n = len(cell_ids)
        X = np.zeros((n, len(centers_km)))
        for c, (cx, cy) in enumerate(centers_km):
            d = np.hypot(pos_km[:, 0] - cx, pos_km[:, 1] - cy)
            g = 10.0 ** (-PATHLOSS_DB(d) / 10.0)
            X[:, c] = self.load * g * p_watt / (bandwidth_mhz * 1e6) / N0
        X[np.arange(n), cell_ids] = 0.0
        return X


# ---------------------------------------------------------------------------
# fleet specification
# ---------------------------------------------------------------------------


def _pair(x, name: str) -> Tuple[float, float]:
    try:
        lo, hi = x
    except (TypeError, ValueError):
        raise ValueError(f"{name} must be a (lo, hi) pair; got {x!r}") from None
    return (float(lo), float(hi))


@dataclass(frozen=True)
class CellSpec:
    """One cell's geometry and device-population distributions (§VI; the
    defaults reproduce ``sample_fleet``). ``devices = None`` takes
    ``ExperimentSpec.clients``; ``center_km = None`` the cell's slot on
    the ``FleetSpec`` line layout."""

    devices: Optional[int] = None
    center_km: Optional[Tuple[float, float]] = None
    radius_km: float = CELL_RADIUS_KM
    p_dbm: float = DEFAULT_P_DBM
    z_mbit: float = DEFAULT_Z_MBIT
    e_cons_range: Tuple[float, float] = DEFAULT_E_CONS_RANGE
    cycles_range: Tuple[float, float] = DEFAULT_CYCLES_RANGE
    samples_range: Tuple[int, int] = DEFAULT_SAMPLES_RANGE
    f_min_ghz: float = DEFAULT_F_MIN_GHZ
    f_max_ghz: float = DEFAULT_F_MAX_GHZ
    alpha: float = DEFAULT_ALPHA

    def __post_init__(self):
        for name in ("e_cons_range", "cycles_range"):
            object.__setattr__(self, name, _pair(getattr(self, name), name))
        lo, hi = _pair(self.samples_range, "samples_range")
        object.__setattr__(self, "samples_range", (int(lo), int(hi)))
        if self.center_km is not None:
            object.__setattr__(self, "center_km",
                               _pair(self.center_km, "center_km"))

    def resolved_devices(self, default: Optional[int]) -> int:
        n = self.devices if self.devices is not None else default
        if n is None or n <= 0:
            raise ValueError(
                "CellSpec.devices is unset and no default device count was "
                "given (pass clients= to build_fleet / set it on the "
                "ExperimentSpec)")
        return int(n)


@dataclass(frozen=True)
class FleetSpec:
    """The physical scenario: cells, channel model, shared constants.
    ``channel`` is a registry reference (``"static"``,
    ``"rayleigh-block:0.01"``, ``{"name": ..., "params": {...}}``)."""

    cells: Tuple[CellSpec, ...] = (CellSpec(),)
    channel: Union[str, Dict[str, Any]] = "static"
    isd_km: float = 2.0 * CELL_RADIUS_KM        # line-layout site distance
    local_iters: int = DEFAULT_LOCAL_ITERS      # the fleet's L (eq. 16)
    noise_dbm_per_hz: float = NOISE_DBM_PER_HZ
    version: int = FLEET_SPEC_VERSION

    def __post_init__(self):
        cells = tuple(c if isinstance(c, CellSpec) else CellSpec(**c)
                      for c in self.cells)
        if not cells:
            raise ValueError("FleetSpec needs at least one cell")
        object.__setattr__(self, "cells", cells)
        object.__setattr__(self, "channel",
                           CHANNELS.canonical(self.channel))

    @property
    def num_cells(self) -> int:
        return len(self.cells)

    def centers_km(self):
        """BS positions: an explicit ``center_km``, else a line along x
        ``isd_km`` apart."""
        return [c.center_km if c.center_km is not None
                else (i * self.isd_km, 0.0)
                for i, c in enumerate(self.cells)]

    def replace(self, **kw) -> "FleetSpec":
        return dataclasses.replace(self, **kw)

    # ---- serialization (as ExperimentSpec) ---------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FleetSpec":
        d = dict(d)
        version = d.pop("version", FLEET_SPEC_VERSION)
        if version > FLEET_SPEC_VERSION:
            raise ValueError(f"fleet spec version {version} is newer than "
                             f"supported {FLEET_SPEC_VERSION}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FleetSpec fields: {sorted(unknown)}")
        return cls(version=version, **d)

    @classmethod
    def from_json(cls, s: str) -> "FleetSpec":
        return cls.from_dict(json.loads(s))


def multicell_fleet_spec(num_cells: int, **kw) -> FleetSpec:
    """``num_cells`` default cells on the line layout, under the
    interference channel once there is more than one cell."""
    channel = kw.pop("channel",
                     "multicell-interference" if num_cells > 1 else "static")
    return FleetSpec(cells=tuple(CellSpec() for _ in range(num_cells)),
                     channel=channel, **kw)


def population_fleet_spec(num_clients: int, **kw) -> FleetSpec:
    """One static cell serving ``num_clients`` devices."""
    return FleetSpec(cells=(CellSpec(devices=int(num_clients)),), **kw)


# ---------------------------------------------------------------------------
# build_fleet: FleetSpec → Fleet
# ---------------------------------------------------------------------------


def build_fleet(spec: FleetSpec, seed: int = 0, *,
                clients: Optional[int] = None,
                bandwidth_mhz: float = DEFAULT_B_MHZ) -> Fleet:
    """The :class:`~repro_torch.core.wireless.Fleet` of ``spec``.

    Cell ``i`` draws from ``np.random.default_rng(seed + i·stride)`` in
    ``sample_fleet``'s order — radius, (multi-cell only: angle), shadowing,
    cycles, samples, energy budgets — so ``FleetSpec()`` is
    ``sample_fleet(clients, seed)`` bit for bit. ``bandwidth_mhz`` is the
    per-cell reuse band the interference PSD normalizes over."""
    channel = CHANNELS.resolve(spec.channel)
    centers = spec.centers_km()
    multi = spec.num_cells > 1
    parts = []
    for i, cell in enumerate(spec.cells):
        n = cell.resolved_devices(clients)
        rng = np.random.default_rng(seed + i * CELL_SEED_STRIDE)
        r_km = cell.radius_km * np.sqrt(rng.uniform(0.01, 1.0, n))
        theta = rng.uniform(0.0, 2.0 * math.pi, n) if multi \
            else np.zeros(n)
        h = channel.sample_gains(rng, r_km)
        parts.append(dict(
            h=h,
            p=np.full(n, dbm_to_watt(cell.p_dbm)),
            z=np.full(n, cell.z_mbit),
            C=rng.uniform(*cell.cycles_range, n),
            D=rng.integers(cell.samples_range[0], cell.samples_range[1] + 1,
                           n).astype(np.float64),
            alpha=np.full(n, cell.alpha),
            f_min=np.full(n, cell.f_min_ghz),
            f_max=np.full(n, cell.f_max_ghz),
            e_cons=rng.uniform(*cell.e_cons_range, n),
            cell=np.full(n, i, np.int32),
            pos=np.stack([centers[i][0] + r_km * np.cos(theta),
                          centers[i][1] + r_km * np.sin(theta)], axis=1),
        ))

    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    pos = cat.pop("pos")
    N0 = dbm_to_watt(spec.noise_dbm_per_hz)
    inr = np.zeros(len(cat["h"]))
    xgain = None
    if hasattr(channel, "cross_gain_matrix"):
        # dynamic interference: each device's per-BS contribution; the
        # round's I/N0 is reduced from the selections (build-time inr 0)
        xgain = channel.cross_gain_matrix(pos, cat["p"], cat["cell"],
                                          centers, bandwidth_mhz, N0)
    elif hasattr(channel, "cross_cell_inr"):
        inr = channel.cross_cell_inr(pos, cat["p"], cat["cell"], centers,
                                     bandwidth_mhz, N0)
    return Fleet(L=spec.local_iters, N0=N0, inr=inr, xgain=xgain, **cat)
