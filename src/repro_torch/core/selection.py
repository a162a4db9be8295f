"""Device selection — paper §IV, Algorithm 4 (a numpy copy of
``repro.core.selection.select_divergence``)."""
from __future__ import annotations

from typing import Sequence

import numpy as np


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
