"""Deterministic synthetic datasets with the shape/class structure of the
paper's benchmarks (MNIST / CIFAR-10 / FashionMNIST) — a numpy copy of
``repro.data.synthetic.make_dataset``, byte-identical for equal arguments.

Each class has a smooth random template; samples are template + per-sample
shift + pixel noise. The templates are seeded from crc32 of the dataset
name, so train/test splits (different seeds) share the class structure.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.paper_cnn import CNN_CONFIGS


@dataclass
class Dataset:
    images: np.ndarray       # [N, H, W, C] float32 in [0, 1]
    labels: np.ndarray       # [N] int32
    num_classes: int


def _class_templates(rng, num_classes, h, w, c):
    """Smooth low-frequency class templates (random fourier features)."""
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


def make_dataset(name: str, num_samples: int, seed: int = 0,
                 noise: float = 0.25) -> Dataset:
    """name in {mnist, cifar10, fashion} — shapes follow the paper (Table II)."""
    cfg = CNN_CONFIGS[name]
    h, w = cfg.input_hw
    c = cfg.input_channels
    # crc32, not hash(): str hashing is salted per process
    tmpl_rng = np.random.default_rng(zlib.crc32(name.encode()))
    templates = _class_templates(tmpl_rng, cfg.num_classes, h, w, c)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.num_classes, num_samples).astype(np.int32)
    shift = rng.integers(-2, 3, (num_samples, 2))
    images = np.empty((num_samples, h, w, c), np.float32)
    base = templates[labels]
    for i in range(num_samples):
        images[i] = np.roll(base[i], tuple(shift[i]), axis=(0, 1))
    images += rng.normal(0.0, noise, images.shape).astype(np.float32)
    images = np.clip(images, 0.0, 1.0)
    return Dataset(images=images, labels=labels, num_classes=cfg.num_classes)


def make_token_stream(vocab_size: int, num_tokens: int, seed: int = 0,
                      order: int = 2) -> np.ndarray:
    """Markov token stream — gives LM training a learnable structure (a
    copy of ``repro.data.synthetic.make_token_stream``, the same draws)."""
    rng = np.random.default_rng(seed)
    ctx = min(64, vocab_size)
    trans = rng.dirichlet(np.ones(ctx) * 0.1, size=ctx)
    toks = np.zeros(num_tokens, np.int64)
    s = 0
    for i in range(num_tokens):
        s = rng.choice(ctx, p=trans[s])
        toks[i] = s % vocab_size
    return toks.astype(np.int32)
