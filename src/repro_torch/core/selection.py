"""Device-selection policies — paper §IV (Algorithms 3-4) and the compared
baselines, numpy copies of ``repro.core.selection`` that make the same
``np.random.Generator`` calls:

  divergence      : Algorithm 4 — top-s weight divergence per cluster (ours)
  kmeans_random   : Algorithm 3 — s random devices per cluster
  random          : FedAvg [31] — S uniform devices
  icas            : ICAS [42] — importance (update norm) × channel-aware rank
  rra             : RRA [39] — energy-efficient participation thresholding

All return a 1-D int array of selected device indices.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def select_random(rng: np.random.Generator, num_devices: int,
                  S: int) -> np.ndarray:
    return rng.choice(num_devices, size=S, replace=False)


def select_kmeans_random(rng: np.random.Generator,
                         clusters: Sequence[np.ndarray],
                         s: int = 1) -> np.ndarray:
    """Algorithm 3: s random devices from each cluster."""
    out = []
    for members in clusters:
        if len(members) == 0:
            continue
        take = min(s, len(members))
        out.append(rng.choice(members, size=take, replace=False))
    return np.concatenate(out)


def select_divergence(divergences: np.ndarray, clusters: Sequence[np.ndarray],
                      s: int = 1) -> np.ndarray:
    """Algorithm 4: from each cluster the devices with the TOP-s weight
    divergence ‖w_n − w_global‖ (most informative local datasets)."""
    out = []
    for members in clusters:
        if len(members) == 0:
            continue
        take = min(s, len(members))
        order = np.argsort(-np.asarray(divergences)[members])
        out.append(members[order[:take]])
    return np.concatenate(out)


def select_icas(update_norms: np.ndarray, rates: np.ndarray, S: int,
                beta: float = 0.5) -> np.ndarray:
    """ICAS [42]: importance- and channel-aware scheduling; the score is a
    geometric blend of update importance and channel rate (their
    multiplicative rule, deterministic top-S)."""
    u = np.asarray(update_norms, np.float64)
    r = np.asarray(rates, np.float64)
    u = u / max(u.max(), 1e-12)
    r = r / max(r.max(), 1e-12)
    score = (u ** beta) * (r ** (1.0 - beta))
    return np.argsort(-score)[:S]


def select_rra(rng: np.random.Generator, e_com_at_equal_share: np.ndarray,
               e_budget: np.ndarray, target_mean: int = 45) -> np.ndarray:
    """RRA [39]: devices whose uplink energy at an equal band share stays
    well inside budget participate; the set size varies per round (~45 on
    average in §VI-C)."""
    eff = e_budget / np.maximum(e_com_at_equal_share, 1e-12)
    # participation probability grows with energy efficiency
    p = np.clip(eff / np.percentile(eff, 100 * min(
        1.0, target_mean / len(eff))), 0.0, 1.0)
    # rescale toward the target mean, never above probability one
    scale = min(1.0, target_mean / max(p.sum(), 1e-9))
    mask = rng.uniform(size=len(eff)) < p * scale
    if not mask.any():
        mask[np.argmax(eff)] = True
    return np.flatnonzero(mask)
