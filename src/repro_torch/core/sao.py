"""SAO — energy-efficient Spectrum Allocation Optimization (paper §V, Alg. 5).

Solves, per global iteration k (problem (19)):

    min_{b, f} T_k
    s.t.  G_n f_n² + H_n / Q_n(b_n) ≤ e_cons_n          (19a) energy
          z_n / Q_n(b_n) + U_n / f_n ≤ T_k              (19b) deadline
          Σ_n b_n ≤ B                                   (19c) total bandwidth
          f_min ≤ f_n ≤ f_max                           (19d)
    where Q_n(b) = b·log2(1 + J_n/b)   (monotone ↑, sup = J_n/ln2, Lemma 2).

At the optimum every device finishes at T_k*, every energy budget is tight
and the full band is used (Theorem 1); eliminating Q gives the per-device
cubic (23) f³ + (H·T/(z·G) − e_cons/G)·f − H·U/(z·G) = 0 with a unique
positive root (Lemma 3). Algorithm 5 is a three-level bisection: outer on
T_k, inner per device on f (cubic) and on b (monotone Q).

Everything is fp32 tensors on the fleet's device, vectorised over devices
and over an optional leading lane axis (a cohort's seeds: ``arr`` of
``[B, S]``, one independent solve a lane, where the reference ``vmap``s).
The reference's outer ``lax.while_loop`` becomes a fixed ``n_outer`` loop
with a sticky ``done`` mask per lane: once a lane's band ratio lands in
[1−eps0, 1] its bracket is pinned to that T and later iterations leave it
there, so no iteration reads a value back to the host. On the card that
solve (about 50,000 small launches, whatever the lane count) is captured
per (device, shape, mask, parameters) at its second call as a CUDA graph
and replayed from then on (``repro_torch.core.graphs.GraphCache``): the
same launches and bits, without the host's per-launch cost. A CPU tensor,
a shape's first solve, or a solve inside a captured round, runs
:func:`_sao_body` itself.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import torch

from repro_torch.core.graphs import GraphCache, graph_key, replays
from repro_torch.core.wireless import (LN2, device_scalar, effective_arrays,
                                       masked_max, masked_sum, rate_mbps)


class SAOSolution(NamedTuple):
    T: torch.Tensor            # optimal round latency T_k*  [s]
    b: torch.Tensor            # per-device bandwidth [MHz]
    f: torch.Tensor            # per-device CPU frequency [GHz]
    converged: torch.Tensor    # outer bisection reached the ratio band
    ratio: torch.Tensor        # Σb/B at the returned T


def _Q(b, J):
    """Q_n(b) = b log2(1 + J/b) — Lemma 2 (monotone ↑, bounded by J/ln2)."""
    return rate_mbps(b, J)


def _solve_cubic_f(T, arr, n_iters: int) -> torch.Tensor:
    """Unique positive root of (23): f³ + X·f − Y = 0 (Lemma 3), bisected.

    Root upper bound: cbrt(Y) + sqrt(max(−X,0)/3) + 1. torch has no cbrt;
    Y = H·U/(z·G) > 0, so ``Y ** (1/3)`` is the real cube root.
    """
    X = arr["H"] * T / (arr["z"] * arr["G"]) - arr["e_cons"] / arr["G"]
    Y = arr["H"] * arr["U"] / (arr["z"] * arr["G"])
    lo = torch.zeros_like(Y)
    hi = Y ** (1.0 / 3.0) + torch.sqrt(torch.clamp(-X, min=0.0) / 3.0) + 1.0
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        pos = mid * mid * mid + X * mid - Y > 0.0
        lo, hi = torch.where(pos, lo, mid), torch.where(pos, mid, hi)
    return 0.5 * (lo + hi)


def _solve_b_from_energy(f, arr, b_max, n_iters: int) -> torch.Tensor:
    """Solve (21): Q(b) = H / (e_cons − G·f²) for b by bisection (Lemma 2).
    Devices with no comm-energy budget left, or whose required Q exceeds
    the supremum J/ln2, are clipped to b_max (Alg. 5 line 9)."""
    resid = arr["e_cons"] - arr["G"] * torch.square(f)
    target = arr["H"] / torch.clamp(resid, min=1e-12)
    achievable = ((resid > 0.0) & (target < arr["J"] / LN2)
                  & (_Q(b_max, arr["J"]) >= target))
    lo = torch.full_like(f, 1e-9)
    hi = b_max.expand(f.shape).to(f.dtype)
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        ge = _Q(mid, arr["J"]) >= target
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return torch.where(achievable, 0.5 * (lo + hi), b_max)


def _solve_b_from_deadline(T, f, arr, b_max, n_iters: int) -> torch.Tensor:
    """Solve (20): Q(b) = z / (T − U/f) for b — for box-clipped devices in
    the box-corrected variant (their energy multiplier is zero, so the
    deadline, not the energy budget, pins b)."""
    slack = T - arr["U"] / f
    target = arr["z"] / torch.clamp(slack, min=1e-9)
    achievable = ((slack > 0.0) & (target < arr["J"] / LN2)
                  & (_Q(b_max, arr["J"]) >= target))
    lo = torch.full_like(f, 1e-9)
    hi = b_max.expand(f.shape).to(f.dtype)
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        ge = _Q(mid, arr["J"]) >= target
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return torch.where(achievable, 0.5 * (lo + hi), b_max)


def _inner_allocate(T, arr, b_max, n_iters: int, box_correct: bool = False):
    """Lines 5-11 of Algorithm 5: f from the cubic, clipped to the box,
    then b from the tight energy constraint (21).

    ``box_correct`` (beyond the paper): a device whose f clipped at a box
    face takes the larger of the deadline's (20) and the energy budget's
    (21) least b — the KKT completion, which stops it from spending band
    to exhaust an energy budget the optimum leaves slack."""
    f_raw = _solve_cubic_f(T, arr, n_iters)
    f = torch.clamp(f_raw, arr["f_min"], arr["f_max"])
    b_energy = _solve_b_from_energy(f, arr, b_max, n_iters)
    if not box_correct:
        return b_energy, f
    b_deadline = _solve_b_from_deadline(T, f, arr, b_max, n_iters)
    clipped = (f_raw < arr["f_min"]) | (f_raw > arr["f_max"])
    b = torch.where(clipped, torch.maximum(b_deadline, b_energy), b_energy)
    return torch.minimum(b, b_max), f


# the captured solves per shape and parameters on the card, as ``jax.jit``
# keeps one compiled program per static shape
_GRAPHS = GraphCache()


def solve_sao(arr: Dict[str, torch.Tensor], B, *, mask=None,
              eps0: float = 1e-3, b_max=None, n_outer: int = 48,
              n_inner: int = 48, box_correct: bool = False) -> SAOSolution:
    """Algorithm 5. ``arr`` = fleet_arrays(fleet.select(S_k)); B in MHz
    (a number or a 0-d tensor, as is ``b_max``).

    Outer bisection on T_k: Σ_n b_n(T) is monotone ↓ in T, so bisection
    converges to the T* where the band is exactly used. ``mask`` ([S]
    bool) marks real lanes of a padded selection; pads are excluded from
    the band sum and delay max and get ``b = f = 0``. With ``arr`` (and
    ``mask``) of ``[B, S]``, B independent solves at one band B: ``T``,
    ``converged`` and ``ratio`` are ``[B]``. On the card the solve replays
    its CUDA graph (:mod:`repro_torch.core.graphs`).
    """
    arr = effective_arrays(arr)
    scalars = (B,) if b_max is None else (B, b_max)
    body = functools.partial(_sao_body, eps0=eps0, n_outer=n_outer,
                             n_inner=n_inner, box_correct=box_correct)
    if not replays(arr["J"]):
        return body(arr, scalars, mask)
    key = graph_key(arr, mask, len(scalars), eps0, n_outer, n_inner,
                    box_correct)
    return _GRAPHS(key, body, arr, scalars, mask)


def _sao_body(arr, scalars, mask, *, eps0: float, n_outer: int,
              n_inner: int, box_correct: bool) -> SAOSolution:
    """The solve itself over an interference-folded ``arr``: ``scalars``
    is ``(B,)`` or ``(B, b_max)``, loaded on the device by fills or device
    copies, so no step waits for the card and a capture may hold it."""
    dev = arr["J"].device
    B = device_scalar(scalars[0], dev)
    b_max = B if len(scalars) == 1 else device_scalar(scalars[1], dev)
    if mask is None:
        mask = torch.ones(arr["J"].shape, dtype=torch.bool, device=dev)

    # the bracket, T and the band ratio are [..., 1] columns: one per lane
    # Line 1: T_min = max_n( ln2·z/J + U/f_max ) — the b→∞, f=f_max limit.
    T_lo = masked_max(LN2 * arr["z"] / arr["J"] + arr["U"] / arr["f_max"],
                      mask, keepdim=True)
    # T_max: slowest CPU + a 1000th of the band each (n counts the lanes of
    # S, padding included: the same n in every lane of a cohort)
    n = arr["J"].shape[-1]
    b_floor = torch.clamp(B / n * 1e-3, min=1e-6)
    T_hi = masked_max(arr["z"] / _Q(b_floor, arr["J"])
                      + arr["U"] / arr["f_min"], mask, keepdim=True) * 2.0
    done = torch.zeros(T_lo.shape, dtype=torch.bool, device=dev)
    for _ in range(n_outer):
        T = 0.5 * (T_lo + T_hi)
        b, _ = _inner_allocate(T, arr, b_max, n_inner, box_correct)
        ratio = masked_sum(b, mask, keepdim=True) / B
        hit = (ratio <= 1.0) & (ratio >= 1.0 - eps0)
        # on a hit pin both ends to T (the returned midpoint IS that T);
        # once done the bracket stays pinned
        T_lo = torch.where(done, T_lo,
                           torch.where(hit | (ratio > 1.0), T, T_lo))
        T_hi = torch.where(done, T_hi,
                           torch.where(hit | (ratio < 1.0 - eps0), T, T_hi))
        done = done | hit
    T = 0.5 * (T_lo + T_hi)

    # final allocation at the converged T (lines 21-22)
    b, f = _inner_allocate(T, arr, b_max, n_inner, box_correct)
    # f* from the clipped b* via the tight energy budget (21), boxed
    Qb = _Q(b, arr["J"])
    resid = arr["e_cons"] - arr["H"] / Qb
    f_star = torch.sqrt(torch.clamp(resid, min=0.0) / arr["G"])
    f_star = torch.clamp(f_star, arr["f_min"], arr["f_max"])
    # keep the better (feasible) of the two candidates per device
    e_star = arr["G"] * torch.square(f_star) + arr["H"] / Qb
    f_final = torch.where(e_star <= arr["e_cons"] + 1e-6, f_star, f)
    t = arr["z"] / Qb + arr["U"] / f_final
    T_star = masked_max(t, mask)
    ratio = masked_sum(b, mask) / B
    zero = torch.zeros_like(b)
    # ratio ≤ 1 at the bracket floor: the band is slack at the optimum
    # (γ* = 0 corner), a converged optimum too
    return SAOSolution(T=T_star, b=torch.where(mask, b, zero),
                       f=torch.where(mask, f_final, zero),
                       converged=done[..., 0] | (ratio <= 1.0), ratio=ratio)


def kkt_residuals(sol: SAOSolution, arr, B):
    """Theorem-1 optimality residuals: delay_spread (eq. 20), energy_slack
    (eq. 21), band_slack (eq. 22), plus the per-device t and e."""
    arr = effective_arrays(arr)
    Q = _Q(sol.b, arr["J"])
    t = arr["z"] / Q + arr["U"] / sol.f
    e = arr["G"] * torch.square(sol.f) + arr["H"] / Q
    return {"delay_spread": torch.max(t) - torch.min(t),
            "energy_slack": arr["e_cons"] - e,
            "band_slack": B - torch.sum(sol.b),
            "t": t, "e": e}
