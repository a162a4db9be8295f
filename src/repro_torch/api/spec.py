"""Declarative experiment specification — one frozen value that fully
determines an FL experiment (the fields of ``repro.api.spec.ExperimentSpec``
that the port reads, with the same names, defaults and seed derivation).

    spec = ExperimentSpec(dataset="fashion", clients=30, sigma=0.8)
    hist = build_experiment(spec).run()          # repro_torch.api.build

Strategy fields take a bare name or a ``{"name", "params"}`` dict and are
stored in the dict form; the port supports the defaults only
(``repro_torch.strategies``). ``model`` is ``"auto"``/``"cnn"`` (the paper
CNN for ``dataset``) or a registered workload name (``"tinyllama"``,
``"mamba2-130m"``: LoRA LM rows). The reference's fields for which the port
has a single value — ``store`` (the dense plane), ``compressor`` (none) —
are left out, so passing one raises ``TypeError``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

from repro_torch import strategies

StrategyRef = Union[str, Dict[str, Any]]


@dataclass(frozen=True)
class ExperimentSpec:
    """Everything needed to rebuild one experiment."""

    # ---- data / partition (paper §VI setup) --------------------------
    dataset: str = "mnist"                 # mnist | cifar10 | fashion
    train_samples: int = 4000
    test_samples: int = 1000
    clients: int = 40                      # N
    samples_per_client: int = 128          # D_n
    sigma: Union[float, str] = 0.8         # non-iid bias; "H" = half-half

    # ---- model -------------------------------------------------------
    model: str = "auto"                    # "auto" | "cnn" → paper CNN for
                                           # dataset; else a registered
                                           # workload name

    # ---- wireless fleet (the paper's §VI single cell) ----------------
    bandwidth_mhz: float = 20.0            # B

    # ---- FL hyper-parameters (FLConfig) ------------------------------
    rounds: int = 30
    devices_per_round: int = 10            # S
    selected_per_cluster: int = 1          # s
    local_iters: int = 20                  # L
    num_clusters: int = 10                 # c
    learning_rate: float = 0.05
    batch_size: int = 32
    target_accuracy: float = 0.0           # 0 → always run ``rounds``
    feature_layer: str = "auto"            # K-means feature (Alg. 2)

    # ---- seeds (None → derived from ``seed``) ------------------------
    seed: int = 0
    data_seed: Optional[int] = None        # default: seed
    test_seed: Optional[int] = None        # default: data_seed + 10_000
    partition_seed: Optional[int] = None   # default: seed + 1
    fleet_seed: Optional[int] = None       # default: seed

    # ---- strategies --------------------------------------------------
    selection: StrategyRef = "divergence"
    allocator: StrategyRef = "sao"
    aggregator: StrategyRef = "fedavg"

    def __post_init__(self):
        if self.model not in ("auto", "cnn"):
            from repro_torch.models.registry import workload_names
            if self.model not in workload_names():
                raise ValueError(f"unknown model {self.model!r}; known: "
                                 f"{('auto', 'cnn') + workload_names()}")
        for name, kind in (("selection", "selector"),
                           ("allocator", "allocator"),
                           ("aggregator", "aggregator")):
            object.__setattr__(self, name,
                               strategies.canonical(kind,
                                                    getattr(self, name)))

    # ---- derived -----------------------------------------------------
    @property
    def resolved_data_seed(self) -> int:
        return self.seed if self.data_seed is None else self.data_seed

    @property
    def resolved_test_seed(self) -> int:
        return (self.resolved_data_seed + 10_000
                if self.test_seed is None else self.test_seed)

    @property
    def resolved_partition_seed(self) -> int:
        return (self.seed + 1 if self.partition_seed is None
                else self.partition_seed)

    @property
    def resolved_fleet_seed(self) -> int:
        return self.seed if self.fleet_seed is None else self.fleet_seed

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)
