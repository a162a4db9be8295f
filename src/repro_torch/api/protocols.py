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
