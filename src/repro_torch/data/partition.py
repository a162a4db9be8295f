"""The paper's σ-bias non-iid partitioner (§IV-A, §VI) — a numpy copy of
``repro.data.partition.partition_bias``, byte-identical for equal seeds.

σ ∈ (0, 1): each client draws σ·D_n samples from its majority class and the
rest uniformly from the other classes.
σ = "H":    80% majority class + 20% a secondary class (two labels only).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np

from repro_torch.data.synthetic import Dataset


@dataclass
class FederatedData:
    """Fixed-size per-client arrays, so local updates run batched."""
    images: np.ndarray        # [N_clients, D, H, W, C]
    labels: np.ndarray        # [N_clients, D]
    majority: np.ndarray      # [N_clients] ground-truth majority class
    sizes: np.ndarray         # [N_clients] nominal D_n (for eq. 4 weights)

    @property
    def num_clients(self) -> int:
        return self.images.shape[0]


def _bias_indices_loop(rng, by_class, K: int, num_clients: int,
                       samples_per_client: int, sigma,
                       majority: np.ndarray) -> np.ndarray:
    """The per-client sample draw, one client at a time (draw order:
    [secondary,] rest, major, shuffle — the reference's rng stream)."""
    idx = np.empty((num_clients, samples_per_client), np.int64)
    for n in range(num_clients):
        m = majority[n]
        if sigma == "H":
            n_major = int(round(0.8 * samples_per_client))
            sec = rng.choice([k for k in range(K) if k != m])
            rest = rng.choice(by_class[sec], samples_per_client - n_major)
        else:
            n_major = int(round(float(sigma) * samples_per_client))
            others = np.concatenate([by_class[k] for k in range(K) if k != m])
            rest = rng.choice(others, samples_per_client - n_major)
        major = rng.choice(by_class[m], n_major)
        sel = np.concatenate([major, rest])
        rng.shuffle(sel)
        idx[n] = sel
    return idx


def partition_bias(ds: Dataset, num_clients: int, samples_per_client: int,
                   sigma: Union[float, str], seed: int = 0,
                   sizes: np.ndarray = None) -> FederatedData:
    """Majority classes are assigned round-robin so every class is some
    client's majority (as in Fig. 4)."""
    rng = np.random.default_rng(seed)
    K = ds.num_classes
    by_class = [np.flatnonzero(ds.labels == k) for k in range(K)]
    majority = np.arange(num_clients) % K
    rng.shuffle(majority)
    idx = _bias_indices_loop(rng, by_class, K, num_clients,
                             samples_per_client, sigma, majority)
    if sizes is None:
        sizes = np.full(num_clients, samples_per_client, np.float64)
    return FederatedData(images=ds.images[idx],
                         labels=ds.labels[idx].astype(np.int32),
                         majority=majority,
                         sizes=np.asarray(sizes, np.float64))
