"""Non-iid client partitioners — the paper's σ-bias scheme (§IV-A, §VI)
and a Dirichlet one — numpy copies of ``repro.data.partition``,
byte-identical for equal seeds.

σ ∈ (0, 1): each client draws σ·D_n samples from its majority class and the
rest uniformly from the other classes.
σ = "H":    80% majority class + 20% a secondary class (two labels only).
A population-scale fleet takes the lazy form (:class:`LazyFederatedData`):
per-client sample indices into the shared pool, not the image stack.
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

    lazy = False

    @property
    def num_clients(self) -> int:
        return self.images.shape[0]


@dataclass
class LazyFederatedData:
    """An index-backed partition for population-scale fleets.

    The ``[N, D, H, W, C]`` image stack at N = 1e6 is about 100× the
    dataset itself (every sample is drawn by many clients); this form
    keeps per-client SAMPLE INDICES into the shared pool, O(N·D) int32,
    and a round gathers its clients' images on the device
    (``pool_images[indices[idx]]``). Only ``store="paged"`` takes it."""
    pool_images: np.ndarray   # [T, H, W, C] the shared sample pool
    indices: np.ndarray       # [N_clients, D] int32 rows into the pool
    labels: np.ndarray        # [N_clients, D]
    majority: np.ndarray      # [N_clients] ground-truth majority class
    sizes: np.ndarray         # [N_clients] nominal D_n (for eq. 4 weights)

    lazy = True

    @property
    def num_clients(self) -> int:
        return self.indices.shape[0]

    @property
    def nbytes(self) -> int:
        return (self.pool_images.nbytes + self.indices.nbytes
                + self.labels.nbytes + self.majority.nbytes
                + self.sizes.nbytes)


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


#: clients at and above which :func:`partition_bias_lazy` draws with the
#: vectorized stream in place of the per-client loop (bit-compatible with
#: :func:`partition_bias`), which takes minutes at 1e6 clients
VECTORIZED_PARTITION_MIN = 100_000


def _bias_indices_vectorized(rng, by_class, K: int, num_clients: int,
                             samples_per_client: int, sigma,
                             majority: np.ndarray) -> np.ndarray:
    """The whole fleet's sample draw in a few vectorized rng calls: the
    loop's σ-bias distribution on a draw stream of its own (deterministic
    in the seed; seconds at 1e6 clients). With replacement, like
    ``rng.choice``."""
    D = samples_per_client
    lens = np.array([len(c) for c in by_class])
    pool = np.zeros((K, lens.max()), np.int64)
    for k, c in enumerate(by_class):
        pool[k, :len(c)] = c
    n_major = int(round((0.8 if sigma == "H" else float(sigma)) * D))

    def draw(cls_per_client, count, cls_pool, cls_lens):
        u = rng.random((num_clients, count))
        col = (u * cls_lens[cls_per_client][:, None]).astype(np.int64)
        return cls_pool[cls_per_client[:, None], col]

    major = draw(majority, n_major, pool, lens)
    if sigma == "H":
        sec = rng.integers(0, K - 1, num_clients)
        sec = sec + (sec >= majority)              # skip the majority class
        rest = draw(sec, D - n_major, pool, lens)
    else:
        olens = lens.sum() - lens                  # |others| per class
        opool = np.zeros((K, int(olens.max())), np.int64)
        for m in range(K):
            opool[m, :olens[m]] = np.concatenate(
                [by_class[k] for k in range(K) if k != m])
        rest = draw(majority, D - n_major, opool, olens)
    return rng.permuted(np.concatenate([major, rest], axis=1), axis=1)


def partition_bias_lazy(ds: Dataset, num_clients: int,
                        samples_per_client: int, sigma: Union[float, str],
                        seed: int = 0,
                        sizes: np.ndarray = None) -> LazyFederatedData:
    """The σ-bias partition as per-client INDICES into the shared pool.

    Below :data:`VECTORIZED_PARTITION_MIN` clients the draws replay
    :func:`partition_bias`'s per-client stream, so the indices select the
    materialized partition's samples for the same seed; from it on the
    vectorized stream draws (same distribution, seed-deterministic)."""
    rng = np.random.default_rng(seed)
    K = ds.num_classes
    by_class = [np.flatnonzero(ds.labels == k) for k in range(K)]
    majority = np.arange(num_clients) % K
    rng.shuffle(majority)
    draw = (_bias_indices_loop if num_clients < VECTORIZED_PARTITION_MIN
            else _bias_indices_vectorized)
    idx = draw(rng, by_class, K, num_clients, samples_per_client, sigma,
               majority)
    if sizes is None:
        sizes = np.full(num_clients, samples_per_client, np.float64)
    return LazyFederatedData(pool_images=ds.images,
                             indices=idx.astype(np.int32),
                             labels=ds.labels[idx].astype(np.int32),
                             majority=majority,
                             sizes=np.asarray(sizes, np.float64))


def partition_dirichlet(ds: Dataset, num_clients: int, samples_per_client: int,
                        alpha: float, seed: int = 0) -> FederatedData:
    """Dirichlet(α) label-distribution partitioner (beyond the paper)."""
    rng = np.random.default_rng(seed)
    K = ds.num_classes
    by_class = [np.flatnonzero(ds.labels == k) for k in range(K)]
    imgs = np.empty((num_clients, samples_per_client) + ds.images.shape[1:],
                    ds.images.dtype)
    labs = np.empty((num_clients, samples_per_client), np.int32)
    majority = np.zeros(num_clients, np.int64)
    for n in range(num_clients):
        pvec = rng.dirichlet(np.full(K, alpha))
        counts = rng.multinomial(samples_per_client, pvec)
        sel = np.concatenate([
            rng.choice(by_class[k], c) for k, c in enumerate(counts) if c > 0])
        rng.shuffle(sel)
        imgs[n] = ds.images[sel]
        labs[n] = ds.labels[sel]
        majority[n] = int(np.argmax(counts))
    return FederatedData(images=imgs, labels=labs, majority=majority,
                         sizes=np.full(num_clients, samples_per_client,
                                       np.float64))
