"""Appendix E — optimal shared transmit power (Algorithm 6)
(``repro.core.power``).

Binary search on a common transmit power p ∈ [p_min, p_max]: a larger p
raises J (a faster uplink) but also H = z·p (more communication energy),
which squeezes the compute-energy budget and forces f down. T_k(p) is
unimodal; Algorithm 6 refines the bracket by comparing each T_k against
the best seen so far. A host loop: each probe is one ``solve_sao`` on
``device`` and one read of its T.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.sao import solve_sao
from repro_torch.core.wireless import (Fleet, dbm_to_watt, fleet_arrays,
                                       watt_to_dbm)


class PowerOptResult(NamedTuple):
    p_star_watt: float
    p_star_dbm: float
    T_star: float
    history: list            # [(p_watt, T_k)]


def optimal_transmit_power(fleet: Fleet, B: float, *,
                           p_min_dbm: float = 10.0, p_max_dbm: float = 23.0,
                           eps3: float = 1e-3, max_epochs: int = 40,
                           device="cuda") -> PowerOptResult:
    """Algorithm 6, wrapping Algorithm 5 (``solve_sao``) per probe."""
    p_low = dbm_to_watt(p_min_dbm)
    p_up = dbm_to_watt(p_max_dbm)

    def T_of(p):
        arr = fleet_arrays(fleet.with_power(p), device)
        return float(solve_sao(arr, B).T)

    history = []
    p = p_low
    epoch = 0
    best_T = np.inf
    while 1.0 - p_low / p_up > eps3 and epoch < max_epochs:
        T_k = T_of(p)
        history.append((float(p), T_k))
        if epoch > 0:
            if T_k <= best_T:
                p_low = p
            else:
                p_up = p
        best_T = min(best_T, T_k)
        p = 0.5 * (p_up + p_low)
        epoch += 1
    p_star = 0.5 * (p_up + p_low)
    return PowerOptResult(p_star_watt=float(p_star),
                          p_star_dbm=float(watt_to_dbm(p_star)),
                          T_star=T_of(p_star), history=history)
