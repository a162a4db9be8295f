"""The host contracts between the round loop and its strategies
(``repro.api.protocols``, host half): what a selector reads for one round,
and what an allocator returns."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Sequence

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
