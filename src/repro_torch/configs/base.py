"""Federated-learning run parameters (a copy of ``repro.configs.base.FLConfig``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning run parameters (paper §III, §VI)."""
    num_devices: int = 100          # N
    devices_per_round: int = 10     # S
    local_iters: int = 5            # L
    num_clusters: int = 10          # c
    selected_per_cluster: int = 1   # s
    learning_rate: float = 0.05     # paper §VI
    sigma: float = 0.8              # non-iid bias; "H" handled by partitioner
    target_accuracy: float = 0.0    # 0 = run max_rounds
    max_rounds: int = 100
    selection: str = "divergence"   # divergence | kmeans_random | random | icas
    feature_layer: str = "auto"     # K-means feature; "auto" = last FC (w_fc2)
