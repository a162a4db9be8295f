"""Spectrum-allocation baselines the paper compares against (§VI-A)
(``repro.core.baselines``).

Baseline 1 — equal bandwidth: b_n = B/S; each device then runs the fastest
CPU frequency its energy budget allows.

Baseline 2 — FEDL [27]: minimize Σ_n e_n + λ·T_k under the band budget
and the frequency box, WITHOUT per-device energy constraints: a log grid
over T, and at each T bandwidth waterfilling (equal marginal energy per
MHz through a dual bisection on μ, each device's b by bisection on its
slope de/db). The §VI-A λ protocol ("λ makes the worst device just meet
its energy budget") is :func:`tune_fedl_lambda`, a bisection on λ.

Everything is fp32 tensors on the fleet arrays' device, with an optional
leading lane axis (a cohort's seeds: arrays of ``[B, S]``, one independent
allocation a lane, where the reference ``vmap``s). The reference's
``lax.map`` over the T grid is one ``[n_grid, S]`` pass (``[B, n_grid,
S]`` with lanes) with the μ bisection as an ``[n_grid, 1]`` column, and every bisection runs a fixed
count with a sticky stop where the reference's ``while_loop`` ends early,
so no step reads a value back to the host. On the card one FEDL solve is
about 50,000 small launches; :func:`fedl_lambda` and
:func:`tune_fedl_lambda` replay it as a CUDA graph captured per (device,
S, n_grid, mask) at its second call — the same launches, without the
host's per-launch cost (``repro_torch.core.graphs.GraphCache``). A CPU
tensor, a shape's first solve, or a solve inside a captured round, runs
:func:`_fedl_solve` itself.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.core.graphs import GraphCache, graph_key, replays
from repro_torch.core.sao import _Q
from repro_torch.core.wireless import (LN2, device_scalar, effective_arrays,
                                       masked_max, masked_sum)

_INV_LN2 = 1.0 / LN2


class AllocResult(NamedTuple):
    T: torch.Tensor
    b: torch.Tensor
    f: torch.Tensor
    e: torch.Tensor            # per-device energy
    feasible: torch.Tensor     # per-device energy constraint satisfied


def equal_bandwidth(arr: Dict[str, torch.Tensor], B: float,
                    mask=None) -> AllocResult:
    """Baseline 1. Every device gets B/S; f maximal within its own budget.

    ``mask`` ([S] bool) marks the real devices of a padded selection: the
    band splits over their count only, pads are left out of the
    reductions and get ``b = f = e = 0``, and an all-False mask gives
    T = 0. Arrays (and mask) of ``[B, S]``: one allocation a lane."""
    arr = effective_arrays(arr)
    J = arr["J"]
    if mask is None:
        b = torch.full_like(J, B / J.shape[-1])
        b_q = b
    else:
        n = torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1)
        b = torch.where(mask, B / n, torch.zeros_like(J))
        b_q = torch.where(mask, b, torch.ones_like(J))   # Q defined on pads
    ecom = arr["H"] / _Q(b_q, J)
    resid = arr["e_cons"] - ecom
    f = torch.sqrt(torch.clamp(resid, min=0.0) / arr["G"])
    f = torch.clamp(f, arr["f_min"], arr["f_max"])
    t = arr["z"] / _Q(b_q, J) + arr["U"] / f
    e = arr["G"] * torch.square(f) + ecom
    if mask is not None:
        e = torch.where(mask, e, torch.zeros_like(e))
        f = torch.where(mask, f, torch.zeros_like(f))
    return AllocResult(T=masked_max(t, mask), b=b, f=f, e=e,
                       feasible=e <= arr["e_cons"] + 1e-6)


# ---------------------------------------------------------------------------
# Baseline 2 — FEDL-style  min Σe + λT
# ---------------------------------------------------------------------------


def _device_energy(b, T, arr):
    """Energy of each device at bandwidth b given deadline T (f minimal)."""
    Q = _Q(b, arr["J"])
    slack = torch.clamp(T - arr["z"] / Q, min=1e-9)
    f = torch.clamp(arr["U"] / slack, arr["f_min"], arr["f_max"])
    return arr["G"] * torch.square(f) + arr["H"] / Q, f


def _slope(b, T, arr, gz2):
    """de/db of :func:`_device_energy`, in closed form (the reference takes
    ``jax.grad`` of the summed energy; each device's energy depends on its
    own b only, so that gradient is this slope). ``gz2`` is 2·G·z.

    With Q = b·log2(1 + J/b), Q' = log2(1 + J/b) − J/((b + J)·ln2),
    slack = max(T − z/Q, 1e-9) and f = clip(U/slack, f_min, f_max):
    de/db = −(2·G·z·f·(U/slack)/slack·[slack and f inside their bounds]
    + H)·Q'/Q². At an exact tie with a bound JAX takes half the gradient,
    this slope all of it (f) or none (slack)."""
    b = torch.clamp(b, min=1e-12)
    x = arr["J"] / b
    opx = 1.0 + x
    lg = torch.log2(opx)
    Q = b * lg
    dQ = lg - x / opx * _INV_LN2
    r = T - arr["z"] / Q
    slack = torch.clamp(r, min=1e-9)
    fr = arr["U"] / slack
    f = torch.clamp(fr, arr["f_min"], arr["f_max"])
    dcmp = torch.where((f == fr) & (r > 1e-9), gz2 * f * fr / slack,
                       torch.zeros((), dtype=b.dtype, device=b.device))
    return -(dcmp + arr["H"]) * dQ / (Q * Q)


def _b_required(T, arr):
    """Least b for the deadline to be *meetable* at f_max:
    Q(b) ≥ z / (T − U/f_max); +inf where no band is enough."""
    slack = T - arr["U"] / arr["f_max"]
    target = arr["z"] / torch.clamp(slack, min=1e-9)
    feasible = (slack > 0.0) & (target < arr["J"] / LN2 * 0.999999)
    lo = torch.full_like(target, 1e-9)
    hi = torch.full_like(target, 1e9)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        ge = _Q(mid, arr["J"]) >= target
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return torch.where(feasible, 0.5 * (lo + hi),
                       torch.full_like(lo, float("inf")))


def _waterfill_b(T, arr, B, n_iters: int = 40, mask=None):
    """Minimize Σ_n e_n(b_n; T) s.t. Σ b_n = B, b_n ≥ b_req_n, for each
    deadline of ``T`` (a scalar, or ``[n_grid, 1]`` against ``[S]``
    devices).

    Equal-marginal condition: de_n/db_n = −μ for unconstrained devices;
    de/db rises in b, so per-device bisection on b nested in a dual
    bisection on μ (one μ per deadline). Masked (padding) lanes are pinned
    to ``b = 0`` and left out of the band sum."""
    b_req = _b_required(T, arr)
    zero = torch.zeros((), dtype=b_req.dtype, device=b_req.device)
    B = device_scalar(B, b_req.device)
    if mask is None:
        b_hi_cap = B.expand(b_req.shape)
    else:
        b_req = torch.where(mask, b_req, zero)
        b_hi_cap = torch.where(mask, B, zero).expand(b_req.shape)
    gz2 = 2.0 * arr["G"] * arr["z"]

    def b_of_mu(mu):
        lo, hi = b_req, b_hi_cap
        neg_mu = -mu
        for _ in range(n_iters):
            mid = 0.5 * (lo + hi)
            up = _slope(mid, T, arr, gz2) < neg_mu   # steeper: grow b
            lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
        return torch.minimum(torch.maximum(0.5 * (lo + hi), b_req), b_hi_cap)

    shape = b_req.shape[:-1] + (1,)
    mu_lo = torch.zeros(shape, dtype=b_req.dtype, device=b_req.device)
    mu_hi = torch.full_like(mu_lo, 1e3)
    for _ in range(n_iters):
        mu = 0.5 * (mu_lo + mu_hi)
        over = torch.sum(b_of_mu(mu), dim=-1, keepdim=True) > B
        mu_lo = torch.where(over, mu, mu_lo)
        mu_hi = torch.where(over, mu_hi, mu)
    b = b_of_mu(0.5 * (mu_lo + mu_hi))
    # rescale any residual mismatch onto unconstrained devices
    excess = B - torch.sum(b, dim=-1, keepdim=True)
    free = b > b_req + 1e-9
    if mask is not None:
        free = free & mask
    count = torch.clamp(torch.sum(free, dim=-1, keepdim=True), min=1)
    b = b + torch.where(free, excess / count, zero)
    return torch.maximum(b, b_req)


def arr_ith(arr, i):
    """Device ``i``'s entries of the fleet arrays (the reference keeps
    this helper for its API)."""
    return {k: v[i] for k, v in arr.items()}


def _linspace(start, stop, num: int):
    """``jnp.linspace`` in its own arithmetic: start·(1 − s) + stop·s for
    s = i/(num − 1), i < num − 1, then ``stop`` itself; along a new last
    axis, one grid per lane of ``start`` and ``stop``."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=start.device) / div
    start, stop = start[..., None], stop[..., None]
    return torch.cat([start * (1 - step) + stop * step, stop], dim=-1)


def _fedl_grid(arr, B, lam, n_grid: int, mask):
    """The objective Σe + λT at each deadline of the log grid, with each
    deadline's waterfilled allocation: ``(T [n_grid], objective [n_grid]
    (+inf where the deadline cannot be met within B), b, f, e
    [n_grid, S])``, each after the lane axis if there is one (``lam``: a
    number, or a tensor of one λ a lane)."""
    J = arr["J"]
    B = device_scalar(B, J.device)
    n = (J.shape[-1] if mask is None
         else torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1))
    # the bracket counts the real lanes only, never the padding
    T_min = masked_max(LN2 * arr["z"] / J + arr["U"] / arr["f_max"],
                       mask) * 1.02
    T_max = masked_max(arr["z"] / _Q(B / n * 0.05, J)
                       + arr["U"] / arr["f_min"], mask)
    Ts = torch.exp(_linspace(torch.log(T_min), torch.log(T_max),
                             n_grid))[..., None]          # [.., n_grid, 1]
    # the devices as a row against the grid's column of deadlines
    grid = {k: v[..., None, :] for k, v in arr.items()}
    gmask = None if mask is None else mask[..., None, :]
    b = _waterfill_b(Ts, grid, B, mask=gmask)
    e, f = _device_energy(b, Ts, grid)
    infeasible = masked_sum(_b_required(Ts, grid), gmask) > B
    if isinstance(lam, torch.Tensor):
        lam = lam[..., None]
    obj = masked_sum(e, gmask) + lam * Ts[..., 0]
    obj = torch.where(infeasible, torch.full_like(obj, float("inf")), obj)
    return Ts[..., 0], obj, b, f, e


def _fedl_solve(arr, B, lam, n_grid: int, mask) -> AllocResult:
    """The FEDL solve over an interference-folded ``arr``: the grid
    deadline of least objective (the first on ties, so index 0 where every
    deadline is infeasible, as ``jnp.argmin`` picks) and its allocation.
    No step reads a value back to the host."""
    _, obj, bs, fs, es = _fedl_grid(arr, B, lam, n_grid, mask)
    i = torch.argmin(obj, dim=-1)[..., None, None]            # per lane
    i = i.expand(i.shape[:-1] + bs.shape[-1:])
    b, f, e = (torch.gather(v, -2, i)[..., 0, :] for v in (bs, fs, es))
    b_q = b if mask is None else torch.where(mask, b, torch.ones_like(b))
    t = arr["z"] / _Q(b_q, arr["J"]) + arr["U"] / f
    if mask is not None:
        b, f, e = (torch.where(mask, v, torch.zeros_like(v))
                   for v in (b, f, e))
    return AllocResult(T=masked_max(t, mask), b=b, f=f, e=e,
                       feasible=e <= arr["e_cons"] + 1e-6)


# the captured solves per shape on the card, as ``jax.jit`` keeps one
# compiled program per static shape
_GRAPHS = GraphCache()


def _solve(arr, B, lam, n_grid: int, mask) -> AllocResult:
    """:func:`_fedl_solve`: a graph replay on the card, eager on the CPU
    and inside a captured round (:func:`repro_torch.core.graphs.replays`).
    """
    if not replays(arr["J"]):
        return _fedl_solve(arr, B, lam, n_grid, mask)
    return _GRAPHS(graph_key(arr, mask, "fedl", n_grid,
                             tuple(getattr(lam, "shape", ()))),
                   lambda a, sc, m: _fedl_solve(a, sc[0], sc[1], n_grid, m),
                   arr, (B, lam), mask)


def fedl_lambda(arr: Dict[str, torch.Tensor], B: float, lam,
                n_grid: int = 120, *, mask=None) -> AllocResult:
    """Baseline 2: grid-refined solve of min_{T,b,f} Σe + λT.

    ``mask`` marks the real lanes of a padded selection; an ``"inr"``
    interference entry in ``arr`` folds into J at entry."""
    return _solve(effective_arrays(arr), B, lam, n_grid, mask)


def tune_fedl_lambda(arr: Dict[str, torch.Tensor], B: float, *, mask=None,
                     lam_lo: float = 1e-3, lam_hi: float = 1e4,
                     iters: int = 24, n_grid: int = 120) -> torch.Tensor:
    """§VI-A λ tuning: 'λ is tuned to make the device with the highest
    energy cost just meet the energy constraint'. A larger λ weighs delay
    more and spends more energy, so bisect λ geometrically down until
    max(e − e_cons) ≤ 0 over the real lanes. ``iters`` steps, each frozen
    once the bracket is within 1e-3 (where the reference's loop stops).
    Returns the largest feasible λ found, a 0-dim tensor on the arrays'
    device (one λ a lane, ``[B]``, for arrays of ``[B, S]``)."""
    arr = effective_arrays(arr)
    J = arr["J"]
    lo = torch.full(J.shape[:-1], lam_lo, dtype=torch.float32,
                    device=J.device)
    hi = torch.full_like(lo, lam_hi)
    for _ in range(iters):
        active = hi > lo * (1.0 + 1e-3)
        mid = torch.sqrt(lo * hi)
        res = _solve(arr, B, mid, n_grid, mask)
        viol = masked_max(res.e - arr["e_cons"], mask) > 0.0
        lo = torch.where(active & ~viol, mid, lo)
        hi = torch.where(active & viol, mid, hi)
    return lo


def tune_fedl_lambda_for_constraints(arr, B, *, lam_lo=1e-3, lam_hi=1e4,
                                     iters=24) -> float:
    """Host-facing wrapper over :func:`tune_fedl_lambda` (the figure
    scripts' λ)."""
    return float(tune_fedl_lambda(arr, B, lam_lo=lam_lo, lam_hi=lam_hi,
                                  iters=iters))
