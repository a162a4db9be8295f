"""Plain float64 reference of SAO (the paper's Algorithm 5, problem (19)):
an outer bisection on the round latency T, inner bisections per device on
the CPU frequency (the cubic (23)) and on the band (the tight energy
budget (21)), then f* from the band and the better feasible candidate.
The port's bracket, iteration counts (48 and 48) and band tolerance
eps0 = 1e-3. Imports only NumPy."""
from __future__ import annotations

import numpy as np

LN2 = float(np.log(2.0))


def _Q(b, J):
    b = np.maximum(b, 1e-12)
    return b * np.log2(1.0 + J / b)


def _cubic_f(T, a, iters):
    X = a["H"] * T / (a["z"] * a["G"]) - a["e_cons"] / a["G"]
    Y = a["H"] * a["U"] / (a["z"] * a["G"])
    lo = np.zeros_like(Y)
    hi = Y ** (1.0 / 3.0) + np.sqrt(np.maximum(-X, 0.0) / 3.0) + 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = mid ** 3 + X * mid - Y > 0.0
        lo, hi = np.where(pos, lo, mid), np.where(pos, mid, hi)
    return 0.5 * (lo + hi)


def _b_energy(f, a, b_max, iters):
    resid = a["e_cons"] - a["G"] * f * f
    target = a["H"] / np.maximum(resid, 1e-12)
    ok = (resid > 0.0) & (target < a["J"] / LN2) & (_Q(b_max, a["J"])
                                                     >= target)
    lo, hi = np.full_like(f, 1e-9), np.full_like(f, b_max)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = _Q(mid, a["J"]) >= target
        lo, hi = np.where(ge, lo, mid), np.where(ge, mid, hi)
    return np.where(ok, 0.5 * (lo + hi), b_max)


def _inner(T, a, b_max, iters):
    f = np.clip(_cubic_f(T, a, iters), a["f_min"], a["f_max"])
    return _b_energy(f, a, b_max, iters), f


def solve(a: dict, B: float, lanes: int = None, eps0: float = 1e-3,
          n_outer: int = 48, n_inner: int = 48):
    """``(T, E, b, f)`` of the devices ``a`` (float64 arrays of the
    solver's constants) at band ``B`` [MHz]: the latency, the summed
    energy, each device's band and frequency. ``lanes``: the lanes of the
    selection, padding included, whose count sets the upper bracket (the
    devices' count by default)."""
    n = a["J"].shape[0] if lanes is None else lanes
    T_lo = np.max(LN2 * a["z"] / a["J"] + a["U"] / a["f_max"])
    b_floor = max(B / n * 1e-3, 1e-6)
    T_hi = np.max(a["z"] / _Q(b_floor, a["J"]) + a["U"] / a["f_min"]) * 2.0
    done = False
    for _ in range(n_outer):
        T = 0.5 * (T_lo + T_hi)
        b, _ = _inner(T, a, B, n_inner)
        ratio = b.sum() / B
        hit = (ratio <= 1.0) and (ratio >= 1.0 - eps0)
        if not done:
            if hit or ratio > 1.0:
                T_lo = T
            if hit or ratio < 1.0 - eps0:
                T_hi = T
        done = done or hit
    T = 0.5 * (T_lo + T_hi)
    b, f = _inner(T, a, B, n_inner)
    Qb = _Q(b, a["J"])
    f_star = np.clip(np.sqrt(np.maximum(a["e_cons"] - a["H"] / Qb, 0.0)
                             / a["G"]), a["f_min"], a["f_max"])
    e_star = a["G"] * f_star ** 2 + a["H"] / Qb
    f_final = np.where(e_star <= a["e_cons"] + 1e-6, f_star, f)
    t = a["z"] / Qb + a["U"] / f_final
    e = a["G"] * f_final ** 2 + a["H"] / Qb
    return float(np.max(t)), float(np.sum(e)), b, f_final
