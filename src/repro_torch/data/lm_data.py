"""Synthetic non-iid next-token data for the federated LM workload (a
numpy copy of ``repro.data.lm_data``, byte-identical for equal arguments).

Each "dialect" is an independent Markov token stream
(:func:`repro_torch.data.synthetic.make_token_stream` with a decorrelated
seed), cut into ``[seq_len + 1]`` windows. Windows ride the
``Dataset.images`` slot and the window's dialect id rides
``Dataset.labels``, so ``partition_bias`` partitions clients by dialect
exactly as it partitions the CNN datasets by image class.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import Dataset, make_token_stream

#: decorrelates per-dialect stream seeds from the dataset seed
DIALECT_SEED_STRIDE = 1009


def make_lm_dataset(num_samples: int, seq_len: int, vocab_size: int,
                    num_dialects: int = 10, seed: int = 0) -> Dataset:
    """``images``: [num_samples, seq_len+1] int32 token windows;
    ``labels``: [num_samples] dialect ids; ``num_classes = num_dialects``.
    Window order is shuffled (seeded)."""
    if num_samples <= 0:
        raise ValueError(f"num_samples must be positive, got {num_samples}")
    per = -(-num_samples // num_dialects)        # windows per dialect (ceil)
    width = seq_len + 1
    windows = np.empty((num_dialects * per, width), np.int32)
    dialects = np.empty((num_dialects * per,), np.int32)
    for d in range(num_dialects):
        stream = np.asarray(make_token_stream(
            vocab_size, per * width,
            seed=seed * DIALECT_SEED_STRIDE + d))
        windows[d * per:(d + 1) * per] = stream[:per * width].reshape(per,
                                                                      width)
        dialects[d * per:(d + 1) * per] = d
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_dialects * per)[:num_samples]
    return Dataset(images=windows[order], labels=dialects[order],
                   num_classes=num_dialects)
