"""The paper's inputs remade from the seeds, in plain NumPy: the synthetic
MNIST-shaped images, the σ-biased non-iid partition and the §VI fleet.
Frozen copies of the port's generators (``repro_torch.data.synthetic.
make_dataset``, ``data.partition.partition_bias``, ``core.wireless.
sample_fleet`` and its eqs. (15)-(18)), so the reference reads the same
data as the program without taking anything the program made."""
from __future__ import annotations

import zlib

import numpy as np


def _class_templates(rng, num_classes, h, w, c):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    templates = np.zeros((num_classes, h, w, c), np.float32)
    for k in range(num_classes):
        img = np.zeros((h, w, c), np.float32)
        for _ in range(6):
            fy, fx = rng.uniform(0.5, 4.0, 2)
            ph = rng.uniform(0, 2 * np.pi, c)
            amp = rng.uniform(0.3, 1.0)
            img += amp * np.sin(2 * np.pi * (fy * yy + fx * xx))[..., None]
            img += amp * 0.3 * np.cos(ph)[None, None, :]
        templates[k] = img
    templates -= templates.min()
    templates /= max(templates.max(), 1e-6)
    return templates


def make_dataset(name: str, hw, channels: int, num_classes: int,
                 num_samples: int, seed: int, noise: float = 0.25):
    """``(images [n, H, W, C] float32, labels [n] int32)``: class templates
    seeded from crc32 of ``name``, each sample its template rolled by a
    shift in [-2, 2] plus pixel noise, clipped to [0, 1]."""
    h, w = hw
    templates = _class_templates(np.random.default_rng(zlib.crc32(
        name.encode())), num_classes, h, w, channels)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_samples).astype(np.int32)
    shift = rng.integers(-2, 3, (num_samples, 2))
    images = np.empty((num_samples, h, w, channels), np.float32)
    base = templates[labels]
    for i in range(num_samples):
        images[i] = np.roll(base[i], tuple(shift[i]), axis=(0, 1))
    images += rng.normal(0.0, noise, images.shape).astype(np.float32)
    return np.clip(images, 0.0, 1.0), labels


def partition_bias(images, labels, num_classes: int, num_clients: int,
                   per_client: int, sigma: float, seed: int):
    """``(images [N, D, ...], labels [N, D], sizes [N])``: each client
    σ·D samples of its majority class (assigned round-robin, shuffled),
    the rest from the other classes."""
    rng = np.random.default_rng(seed)
    by_class = [np.flatnonzero(labels == k) for k in range(num_classes)]
    majority = np.arange(num_clients) % num_classes
    rng.shuffle(majority)
    idx = np.empty((num_clients, per_client), np.int64)
    for n in range(num_clients):
        m = majority[n]
        n_major = int(round(float(sigma) * per_client))
        others = np.concatenate([by_class[k] for k in range(num_classes)
                                 if k != m])
        rest = rng.choice(others, per_client - n_major)
        major = rng.choice(by_class[m], n_major)
        sel = np.concatenate([major, rest])
        rng.shuffle(sel)
        idx[n] = sel
    return (images[idx], labels[idx].astype(np.int32),
            np.full(num_clients, per_client, np.float64))


def fleet(num_devices: int, seed: int) -> dict:
    """§VI: devices uniform in a 300 m cell, 3GPP path loss with 8 dB
    shadowing, -174 dBm/Hz noise, 23 dBm, a 448 KB model, L = 5 for the
    energy model; the solver's constants (15)-(18) in float64:
    ``J`` [MHz], ``U`` [Gcycles], ``G`` [J/GHz²], ``H`` [J·Mbit/Mbit], ``z``
    [Mbit], ``e_cons`` [J], ``f_min``, ``f_max`` [GHz]."""
    rng = np.random.default_rng(seed)
    r_km = 0.3 * np.sqrt(rng.uniform(0.01, 1.0, num_devices))
    pl_db = (128.1 + 37.6 * np.log10(np.maximum(r_km, 1e-3))
             + rng.normal(0.0, 8.0, num_devices))
    h = 10.0 ** (-pl_db / 10.0)
    p = np.full(num_devices, 10.0 ** (23.0 / 10.0) / 1e3)
    z = np.full(num_devices, 448 * 8 * 1024 / 1e6)
    C = rng.uniform(1e4, 3e4, num_devices)
    D = rng.integers(300, 701, num_devices).astype(np.float64)
    e_cons = rng.uniform(30e-3, 60e-3, num_devices)
    n0 = 10.0 ** (-174.0 / 10.0) / 1e3
    L, alpha = 5, 2e-28
    return {"J": h * p / n0 / 1e6, "U": L * C * D / 1e9,
            "G": 0.5 * alpha * L * C * D * 1e18, "H": z * p, "z": z,
            "e_cons": e_cons, "f_min": np.full(num_devices, 0.2),
            "f_max": np.full(num_devices, 2.0)}
