"""Device selection strategy: Algorithm 4, top-s weight divergence per
cluster (``repro.strategies.selectors.DivergenceSelector``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.selection import select_divergence


@dataclass(frozen=True)
class DivergenceSelector:
    """Algorithm 4 (ours): top-s weight divergence per cluster."""

    registry_name = "divergence"
    needs_divergence = True

    def select(self, divergences: np.ndarray,
               clusters: Optional[Sequence[np.ndarray]],
               selected_per_cluster: int) -> np.ndarray:
        if clusters is None:
            raise ValueError("selector 'divergence' needs K-means clusters; "
                             "run the initial round (Algorithm 2) first")
        return select_divergence(divergences, clusters, selected_per_cluster)
