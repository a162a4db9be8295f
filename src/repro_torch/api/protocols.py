"""The contracts between the round loop and its strategies
(``repro.api.protocols``).

* The host half drives the round-at-a-time loop: what a selector reads
  for one round (:class:`SelectionContext`), what an allocator returns
  (:class:`Allocation`).
* The traced half drives the device-resident run
  (``repro_torch.core.engine.run_rounds``): the carry (:class:`RoundState`),
  the static geometry (:class:`TracedContext`) and the fixed-shape
  strategy contracts (:class:`TracedSelector`, :class:`TracedAllocator`).
  A strategy advertises it with ``traceable = True``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, NamedTuple, Optional, Protocol,
                    Sequence, Tuple, runtime_checkable)

import numpy as np


@dataclass
class SelectionContext:
    """Everything a selection policy may consult for one round.

    ``divergences`` is lazy (a callable), so a policy that does not read
    ‖w_n − w_g‖ (``random``) never pays for it; ``rng`` is the
    experiment's host Generator, drawn from only by the policies that
    need it (``needs_rng``)."""
    rng: np.random.Generator
    num_devices: int
    devices_per_round: int            # S
    selected_per_cluster: int         # s (Alg. 3/4)
    bandwidth_mhz: float              # B
    fleet: Any                        # repro_torch.core.wireless.Fleet
    clusters: Optional[Sequence[np.ndarray]]
    divergences: Callable[[], np.ndarray]


class Allocation(NamedTuple):
    """One round's spectrum allocation (eqs. 10-11). The tensors stay on
    the fleet arrays' device until the history reads them."""
    T: Any                            # round delay T_k [s]
    E: Any                            # round energy E_k [J]
    b: Any = None                     # per-device bandwidth [MHz]
    f: Any = None                     # per-device CPU frequency [GHz]


# ---------------------------------------------------------------------------
# the traced half: the device-resident round (``repro_torch.core.engine``)
# ---------------------------------------------------------------------------


class RoundState(NamedTuple):
    """The carry of the device-resident run: everything one FL round reads
    and writes, on the experiment's device, updated in place.

      params        : the flat ``[P]`` global row
      client_params : the ``[N + S_pad, P]`` client plane: row n is client
                      n; the ``S_pad`` rows after them take the padded
                      lanes' writes, one row each, and are never read
      opt_state     : the aggregator's server state (``init_flat_state``;
                      ``None`` for FedAvg)
      labels        : ``[N]`` int64 K-means cluster labels (Alg. 2; zeros
                      until the initial round has run)
      channel       : a fading channel's state, the ``[N, 2]`` (re, im)
                      fade amplitude (``None`` for a stateless channel),
                      set at the start of each device-resident run
      sched         : the per-client statistics table
                      (``repro_torch.core.store.ClientStats`` with tensor
                      columns: divergence, drift, age, in-flight
                      completion time, availability, cell, fault counts,
                      the virtual clock) when the buffered-asynchronous
                      engine runs the ticks (``repro_torch.core.
                      async_engine``); ``None`` on a synchronous run. The
                      store's host table is the source of truth: the
                      carry holds a device copy of it, folded back after
                      the run.

    The aggregator's state is FedAvgM's ``[P]`` momentum. A cohort's carry
    (``repro_torch.core.cohort``) stacks B of these on a leading lane
    axis: ``[B, P]``, ``[B, N + S_pad, P]``, ``[B, N]``, ``[B, N, 2]``;
    ``sched``'s columns ``[B, N]`` and its clock ``[B]``.

    The reference's PRNG ``key`` has no slot: the port's draws are
    arguments of the round (``repro_torch.core.draws``).
    """
    params: Any
    client_params: Any
    opt_state: Any
    labels: Any
    channel: Any = None
    sched: Any = None


@dataclass(frozen=True)
class TracedContext:
    """The static round geometry the traced strategies share. Every field
    sizes the fixed-shape padded index sets, so it keys the captured
    round."""
    num_devices: int                  # N
    devices_per_round: int            # S
    selected_per_cluster: int         # s (Alg. 3/4)
    num_clusters: int                 # c
    bandwidth_mhz: float              # B


@runtime_checkable
class TracedSelector(Protocol):
    """Device selection with a fixed-size result.

    ``select_traced(draw, divergences, labels, arr, ctx)`` returns
    ``(idx, mask)``: ``idx`` int64 of length ``pad_size(ctx)`` whose
    padding lanes hold the sentinel ``ctx.num_devices``, ``mask`` True
    exactly on the real lanes. ``draw`` is the policy's random input,
    drawn by the caller (``[N]`` uniforms, or a permutation of N for
    ``random``: ``draw_kind`` says which), and ``None`` for a
    deterministic policy; nothing draws inside. Every input may carry a
    leading lane axis (a cohort's seeds), and the result then does too.
    """

    traceable: bool
    needs_rng: bool                   # takes a draw?
    needs_divergence: bool            # reads ‖w_n − w_g‖?

    def pad_size(self, ctx: TracedContext) -> int: ...

    def select_traced(self, draw, divergences, labels,
                      arr: Dict[str, Any],
                      ctx: TracedContext) -> Tuple[Any, Any]: ...


@runtime_checkable
class TracedAllocator(Protocol):
    """Spectrum allocation over a padded selected set: ``arr`` holds the
    selected lanes' constants (padding lanes carry a real device's,
    masked); returns tensors ``(T, E, b, f)`` with the padding lanes left
    out of every reduction and at ``b = f = 0``."""

    traceable: bool

    def allocate_traced(self, arr: Dict[str, Any], B: float,
                        mask: Any) -> Tuple[Any, Any, Any, Any]: ...


# ---------------------------------------------------------------------------
# the strategy contracts the registries resolve to
# ---------------------------------------------------------------------------


@runtime_checkable
class ChannelModel(Protocol):
    """Pluggable physical channel (registry: ``CHANNELS`` /
    ``@register_channel``).

    Hooks, by time scale:

    * ``sample_gains(rng, d_km)`` — host-side large-scale fading at fleet
      build time (path loss + shadowing from BS–device distance, a numpy
      ``Generator``); consumed by ``repro_torch.api.scenario.build_fleet``.
    * ``apply_traced(w, arr)`` — MEMORYLESS per-round small-scale fading
      inside the round body: transform the round's ``fleet_arrays`` dict
      (tensors on the experiment's device). ``w`` is the round's fade
      draw (``TorchDraws.channel_step``), taken only when ``needs_rng``;
      a model with ``needs_rng = False`` takes none and leaves the round
      as it is without a channel.
    * ``init_state(h0, arr)`` / ``step_traced(w, state, arr)`` —
      ROUND-COUPLED dynamics for a model with ``stateful = True``: the
      state ``init_state`` returns (the ``[N, 2]`` fade amplitude) rides
      the ``RoundState.channel`` slot of the carry, and every round the
      engine calls ``step_traced`` in place of ``apply_traced`` to evolve
      it and give that round's faded arrays — the Gauss-Markov AR(1)
      amplitude h_t = ρ·h_{t−1} + √(1−ρ²)·w_t. ``h0`` and ``w`` are
      CN(0,1) draws handed in by the caller.

    Cross-cell geometry at build time is a fourth, optional hook: a
    channel with ``cross_gain_matrix(...)`` (``multicell-dynamic``) makes
    ``build_fleet`` precompute each device's interference at every BS,
    and the round body folds the *selected* devices' contributions into
    each cell's rate every round.
    """

    traceable: bool
    needs_rng: bool                   # takes a fade draw a round?
    stateful: bool                    # carries channel state in the carry?

    def sample_gains(self, rng: np.random.Generator,
                     d_km: np.ndarray) -> np.ndarray: ...

    def apply_traced(self, w, arr: Dict[str, Any]) -> Dict[str, Any]: ...

    def init_state(self, h0, arr: Dict[str, Any]) -> Any: ...

    def step_traced(self, w, state: Any,
                    arr: Dict[str, Any]) -> Tuple[Any, Dict[str, Any]]: ...


@runtime_checkable
class Selector(Protocol):
    """Device-selection policy (paper Algorithms 3/4 and baselines): the
    host loop's form; a traceable one is a :class:`TracedSelector` too."""

    def select(self, ctx: SelectionContext) -> np.ndarray: ...


@runtime_checkable
class Allocator(Protocol):
    """Spectrum allocation for a selected set. ``arr`` is the
    ``fleet_arrays`` dict of the selected devices (tensors); ``B`` the
    band [MHz]; ``mask`` (optional) marks the real lanes of a padded
    set."""

    def allocate(self, arr: Dict[str, Any], B: float,
                 mask: Any = None) -> Allocation: ...


@runtime_checkable
class Aggregator(Protocol):
    """Server-side model aggregation, eq. (4) and variants, over the flat
    plane. May be stateful (server momentum); ``reset`` clears that
    state.

    ``init_flat_state(global_vec)`` builds the ``RoundState.opt_state``
    slot (``None`` or a flat ``[P]`` row) and ``aggregate_flat(global_vec,
    rows, weights, opt_state)`` reduces the round's ``[S, P]`` client rows
    (a leading lane axis allowed) in one masked weighted row op
    (``repro_torch.kernels.ops.flat_aggregate``), returning ``(new global
    row, new state)``; ``load_flat_state(opt, spec)`` syncs a finished
    run back into the host object.

    ASYNC contract (buffered aggregation, ``repro_torch.core.
    async_engine``): an aggregator with ``async_capable = True`` also
    exposes ``buffer_size`` (M — the tick fires the server update once M
    in-flight updates have landed) and ``staleness_weights(age)`` (the
    discount ``(1 + age)^(-alpha)`` folded into the weights). The engine
    runs the whole experiment on the tick instead of the round barrier
    whenever the aggregator is async-capable; ``aggregate_flat`` is
    unchanged, so ``fedbuff:M:0`` with a full buffer is the synchronous
    ``fedavg`` round bit for bit.

    FAULT contract: under fault injection (``ExperimentSpec.faults``) the
    engine zeroes the weight of every failed lane but still hands the
    full ``[S, P]`` slab to ``aggregate_flat`` — a zero-weight row may
    carry ANY payload, NaN included (a corrupted upload), so an
    aggregator must never let a zero-weight lane touch the fold
    (``ops.flat_aggregate`` skips those rows, the trimmed mean sorts
    them to +inf). An all-zero weight vector is the DRIVER's (the round
    is a no-op); ``aggregate_flat`` is never asked to invent a fallback.
    Robust registry aggregators: ``trimmed:f`` (coordinate-wise trimmed
    mean, unweighted), ``clipnorm:c`` (delta-norm clipping, D_n
    weighting kept)."""

    def init_flat_state(self, global_vec: Any) -> Any: ...

    def aggregate_flat(self, global_vec: Any, rows: Any, weights: Any,
                       opt_state: Any) -> Tuple[Any, Any]: ...

    def load_flat_state(self, opt_state: Any, spec: Any) -> None: ...

    def reset(self) -> None: ...


@runtime_checkable
class Compressor(Protocol):
    """Simulated lossy uplink compression of client updates."""

    identity: bool

    def apply_flat(self, rows: Any, global_vec: Any, spec: Any) -> Any:
        """Compress the round's ``[S, P]`` rows (a leading lane axis
        allowed) as *deltas* against the ``[P]`` global row; ``spec`` is
        the ``StackFlattenSpec`` giving each leaf's column segment, so
        per-leaf scales and thresholds stay exact."""
        ...

    def payload_mbit(self, num_params: int,
                     num_leaves: int) -> Optional[float]:
        """Uplink payload z_n [Mbit], or None to keep the fleet's own z."""
        ...
