"""Wireless system model — paper §III-B, eqs (5)–(11) and §VI parameters.

Scaled units as in the reference (``docs/UNITS.md``): frequency GHz,
bandwidth MHz, model size Mbit, power W, time s, energy J, CPU work Gcycles,
noise W/Hz — float32-safe for the SAO pipeline. The FDMA rate (7) is
r[Mbit/s] = b[MHz]·log2(1 + J/b) with J = h·p/N0 in MHz; inter-cell
interference folds in as J_eff = J / (1 + inr).

The per-device draw (:class:`Fleet`, :func:`sample_fleet`) is host numpy,
byte-identical to ``repro.core.wireless``; multi-cell topologies and the
channel models are built in ``repro_torch.api.scenario``.
:func:`fleet_arrays` hands the solver-facing constants to the device as
fp32 tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LN2 = float(np.log(2.0))

# §VI experiment constants
PATHLOSS_DB = lambda d_km: 128.1 + 37.6 * np.log10(np.maximum(d_km, 1e-3))
SHADOW_STD_DB = 8.0
NOISE_DBM_PER_HZ = -174.0
CELL_RADIUS_KM = 0.3
DEFAULT_P_DBM = 23.0
DEFAULT_B_MHZ = 20.0
DEFAULT_F_MAX_GHZ = 2.0
DEFAULT_F_MIN_GHZ = 0.2
DEFAULT_Z_MBIT = 448 * 8 * 1024 / 1e6        # 448 KB model (MNIST CNN, Table II)
DEFAULT_ALPHA = 2e-28                         # effective capacitance 2·(α/2)
DEFAULT_LOCAL_ITERS = 5
DEFAULT_CYCLES_PER_SAMPLE = 2e4
DEFAULT_SAMPLES = 500
DEFAULT_E_CONS_RANGE = (30e-3, 60e-3)
DEFAULT_CYCLES_RANGE = (1e4, 3e4)
DEFAULT_SAMPLES_RANGE = (300, 700)


def dbm_to_watt(dbm):
    return 10.0 ** (np.asarray(dbm) / 10.0) / 1e3


def watt_to_dbm(w):
    return 10.0 * np.log10(np.asarray(w) * 1e3)


@dataclass
class Fleet:
    """Per-device physical parameters for N devices, of one cell or of a
    multi-cell topology (``repro_torch.api.scenario.build_fleet``)."""
    h: np.ndarray            # channel gain (linear)
    p: np.ndarray            # transmit power [W]
    z: np.ndarray            # model size [Mbit]
    C: np.ndarray            # cycles per sample
    D: np.ndarray            # local dataset size [samples]
    L: int                   # local iterations
    alpha: np.ndarray        # capacitance coefficient (e_cmp uses α/2)
    f_min: np.ndarray        # [GHz]
    f_max: np.ndarray        # [GHz]
    e_cons: np.ndarray       # per-device energy budget [J]
    N0: float                # noise PSD [W/Hz]
    cell: np.ndarray = None  # serving-cell index per device (0: one cell)
    inr: np.ndarray = None   # interference-to-noise ratio I/N0 (0: one cell)
    xgain: np.ndarray = None  # [N, C] inr a device adds at each BS when it
                              # transmits (dynamic interference; own-cell
                              # column 0), else None
    n_cells: int = None      # the topology's cell count (a sub-fleet keeps
                              # its parent's)

    def __post_init__(self):
        if self.cell is None:
            self.cell = np.zeros(np.shape(self.h), np.int32)
        if self.inr is None:
            self.inr = np.zeros(np.shape(self.h), np.float64)
        if self.n_cells is None:
            self.n_cells = (int(np.max(self.cell)) + 1 if len(self.h)
                            else 1)

    @property
    def num_devices(self) -> int:
        return len(self.h)

    @property
    def num_cells(self) -> int:
        """Cell count of the topology this fleet was drawn from."""
        return self.n_cells

    # --- the paper's composite constants, eqs (15)-(18), scaled units ---
    def J_mhz(self):
        """J_n = h p / N0, expressed in MHz."""
        return self.h * self.p / self.N0 / 1e6

    def U_gcycles(self):
        """U_n = L·C_n·D_n in Gcycles (eq. 16)."""
        return self.L * self.C * self.D / 1e9

    def G_joule_per_ghz2(self):
        """G_n = (α/2)·L·C_n·D_n so that e_cmp = G·f² with f in GHz (eq. 17)."""
        return 0.5 * self.alpha * self.L * self.C * self.D * 1e18

    def H_joule(self):
        """H_n = z_n·p_n: e_com = H / (b·log2(1+J/b))."""
        return self.z * self.p

    def select(self, idx) -> "Fleet":
        idx = np.asarray(idx)
        return Fleet(h=self.h[idx], p=self.p[idx], z=self.z[idx],
                     C=self.C[idx], D=self.D[idx], L=self.L,
                     alpha=self.alpha[idx], f_min=self.f_min[idx],
                     f_max=self.f_max[idx], e_cons=self.e_cons[idx],
                     N0=self.N0, cell=self.cell[idx], inr=self.inr[idx],
                     xgain=None if self.xgain is None else self.xgain[idx],
                     n_cells=self.n_cells)

    def cell_fleet(self, c: int) -> "Fleet":
        """The sub-fleet cell ``c`` serves (device order kept;
        ``num_cells`` stays the topology's)."""
        return self.select(np.flatnonzero(np.asarray(self.cell) == c))

    def with_power(self, p_watt) -> "Fleet":
        """The same fleet at transmit power ``p_watt`` (one value or one
        per device); Algorithm 6 probes these. ``xgain`` rows scale with
        their device's power (X[n, c] ∝ p_n)."""
        p = np.broadcast_to(np.asarray(p_watt, np.float64),
                            self.h.shape).copy()
        xgain = (None if self.xgain is None
                 else self.xgain * (p / self.p)[:, None])
        return Fleet(h=self.h, p=p, z=self.z, C=self.C, D=self.D, L=self.L,
                     alpha=self.alpha, f_min=self.f_min, f_max=self.f_max,
                     e_cons=self.e_cons, N0=self.N0, cell=self.cell,
                     inr=self.inr, xgain=xgain, n_cells=self.n_cells)


def sample_fleet(num_devices: int = 100, seed: int = 0, *,
                 p_dbm: float = DEFAULT_P_DBM,
                 z_mbit: float = DEFAULT_Z_MBIT,
                 e_cons_range=DEFAULT_E_CONS_RANGE,
                 cycles_range=DEFAULT_CYCLES_RANGE,
                 samples_range=DEFAULT_SAMPLES_RANGE,
                 local_iters: int = DEFAULT_LOCAL_ITERS) -> Fleet:
    """§VI setup: N devices uniform in a 300 m cell, 3GPP path loss + 8 dB
    lognormal shadowing, -174 dBm/Hz noise."""
    rng = np.random.default_rng(seed)
    r_km = CELL_RADIUS_KM * np.sqrt(rng.uniform(0.01, 1.0, num_devices))
    pl_db = PATHLOSS_DB(r_km) + rng.normal(0.0, SHADOW_STD_DB, num_devices)
    h = 10.0 ** (-pl_db / 10.0)
    return Fleet(
        h=h,
        p=np.full(num_devices, dbm_to_watt(p_dbm)),
        z=np.full(num_devices, z_mbit),
        C=rng.uniform(*cycles_range, num_devices),
        D=rng.integers(samples_range[0], samples_range[1] + 1,
                       num_devices).astype(np.float64),
        L=local_iters,
        alpha=np.full(num_devices, DEFAULT_ALPHA),
        f_min=np.full(num_devices, DEFAULT_F_MIN_GHZ),
        f_max=np.full(num_devices, DEFAULT_F_MAX_GHZ),
        e_cons=rng.uniform(*e_cons_range, num_devices),
        N0=dbm_to_watt(NOISE_DBM_PER_HZ),
    )


# --- eqs (5)-(9) over scaled quantities ------------------------------------


def rate_mbps(b_mhz, J_mhz):
    """Achievable FDMA rate, eq (7): r = b·log2(1 + J/b) [Mbit/s]."""
    b = torch.clamp(b_mhz, min=1e-12)
    return b * torch.log2(1.0 + J_mhz / b)


def t_cmp(U_gcycles, f_ghz):
    """Computation delay, eq (5): t = L·C·D / f."""
    return U_gcycles / torch.clamp(f_ghz, min=1e-12)


def e_cmp(G, f_ghz):
    """Computation energy, eq (6): e = (α/2)·L·C·D·f²."""
    return G * torch.square(f_ghz)


def t_com(z_mbit, b_mhz, J_mhz):
    """Communication delay, eq (8): t = z / r."""
    return z_mbit / rate_mbps(b_mhz, J_mhz)


def e_com(H, b_mhz, J_mhz):
    """Communication energy, eq (9): e = p·t_com = H / (b·log2(1+J/b))."""
    return H / rate_mbps(b_mhz, J_mhz)


def effective_arrays(arr):
    """Fold the interference term into the channel constant: the returned
    copy has ``J = J / (1 + inr)`` and no ``"inr"`` key, so the fold is
    idempotent; ``inr == 0`` divides by exactly 1.0."""
    if "inr" not in arr:
        return arr
    out = dict(arr)
    inr = out.pop("inr")
    out["J"] = arr["J"] / (1.0 + inr)
    return out


def completion_times(arr, b_mhz, f_ghz, mask=None):
    """Per-device delay of one update under an allocation: t_com + t_cmp
    (eqs. 5+8); masked-out lanes are +inf."""
    fa = effective_arrays(arr)
    d = t_com(fa["z"], b_mhz, fa["J"]) + t_cmp(fa["U"], f_ghz)
    if mask is None:
        return d
    return torch.where(mask, d, torch.full_like(d, float("inf")))


def device_scalar(x, device) -> torch.Tensor:
    """``x`` as a 0-d fp32 tensor on ``device``: a tensor as it is (cast),
    a number by a fill on the device, never by a copy from the host (which
    waits for the card, and which a CUDA graph capture refuses)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def masked_max(x, mask=None, empty=0.0, keepdim: bool = False):
    """Max over the real lanes, the last axis (so one max per row of a
    leading batch: a cohort's seeds, a grid of deadlines); a row whose
    mask is all False gives ``empty`` (a number, or a tensor of the
    result's shape, e.g. a tick's clock: nothing reads it on the host)."""
    if mask is None:
        return torch.amax(x, dim=-1, keepdim=keepdim)
    m = torch.amax(torch.where(mask, x, torch.full_like(x, -float("inf"))),
                   dim=-1, keepdim=keepdim)
    if not isinstance(empty, torch.Tensor):
        empty = torch.full_like(m, empty)
    return torch.where(torch.any(mask, dim=-1, keepdim=keepdim), m, empty)


def masked_sum(x, mask=None, keepdim: bool = False):
    """Sum over the real lanes, the last axis (pads contribute exactly
    0)."""
    if mask is None:
        return torch.sum(x, dim=-1, keepdim=keepdim)
    return torch.sum(torch.where(mask, x, torch.zeros_like(x)), dim=-1,
                     keepdim=keepdim)


def round_totals(fleet_arrays, b_mhz, f_ghz):
    """Per-round totals, eqs (10)-(11): (T_k, E_k, per-device t, per-device
    e) of an allocation."""
    fa = effective_arrays(fleet_arrays)
    J, U, G, H, z = (fa[k] for k in ("J", "U", "G", "H", "z"))
    t = t_com(z, b_mhz, J) + t_cmp(U, f_ghz)
    e = e_com(H, b_mhz, J) + e_cmp(G, f_ghz)
    return torch.max(t), torch.sum(e), t, e


def fleet_arrays(fleet, device="cpu"):
    """The solver-facing constants (15)-(18) as fp32 tensors on ``device``:
    ``[N]`` each for one :class:`Fleet`, ``[B, N]`` stacked over the lanes
    for a sequence of B fleets of N devices each (a cohort's lanes).
    ``inr`` rides along for the solvers to fold into J; ``xgain`` (``[N,
    C]``, ``[B, N, C]``) only for a dynamic-interference fleet, and the
    round body pops it before any solver sees the dict."""
    if not isinstance(fleet, Fleet):
        lanes = [fleet_arrays(f, device) for f in fleet]
        return {k: torch.stack([a[k] for a in lanes]) for k in lanes[0]}

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)
    out = {"J": t(fleet.J_mhz()), "U": t(fleet.U_gcycles()),
           "G": t(fleet.G_joule_per_ghz2()), "H": t(fleet.H_joule()),
           "z": t(fleet.z), "e_cons": t(fleet.e_cons),
           "f_min": t(fleet.f_min), "f_max": t(fleet.f_max),
           "inr": t(fleet.inr)}
    if fleet.xgain is not None:
        out["xgain"] = t(fleet.xgain)
    return out
