"""Declarative experiment specification — one frozen, JSON-round-trippable
value that fully determines an FL experiment (the fields of
``repro.api.spec.ExperimentSpec`` that the port reads, with the same
names, defaults, seed derivation and JSON form).

    spec = ExperimentSpec(dataset="fashion", clients=30, sigma=0.8,
                          selection="icas", allocator="fedl_auto")
    hist = build_experiment(spec).run()          # repro_torch.api.build

Strategy fields take a bare name (``"sao"``), the ``name:arg`` shorthand
(``"fedl:2.0"``), a ``{"name", "params"}`` dict or an instance, resolved
through the port's registries and stored in the dict form, so
``ExperimentSpec.from_json(spec.to_json()) == spec``. ``model`` is
``"auto"``/``"cnn"`` (the paper CNN for ``dataset``) or a registered
workload name (``"tinyllama"``, ``"mamba2-130m"``: LoRA LM rows).
``cohort`` is the number of seeds ``build_cohort`` runs as lanes of one
captured round (``repro_torch.core.cohort``). ``fleet`` is the physical
scenario (a ``FleetSpec`` or its dict: cells and channel model,
``repro_torch.api.scenario``); ``compressor`` the uplink compression.
``store`` picks the client store (``"paged"``: the population-scale
host cold store, ``repro_torch.core.store``) with its knobs ``k_max``,
``chunk_size``, ``div_refresh_every``, ``cluster`` and the churn
``churn_leave``/``churn_join`` (stepped before each paged round, or
inside each tick of the buffered-asynchronous engine,
``aggregator="fedbuff:M[:alpha]"``). ``faults`` (a ``FaultSpec``, its
dict or the compact ``"outage:0.1,corrupt:0.01"``,
``repro_torch.core.faults``) and ``quarantine_after`` arm the
fault-tolerant runtime. ``p_shards`` lays the plane's parameter axis
out over a ``model`` mesh of that many devices
(``repro_torch.sharding.specs.plane_mesh``): on one device that is
replication; over several, the device-resident run keeps the plane as
one column block a device (``FLExperiment.plane_split``). Either way the
run is the ``p_shards=0`` run bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import repro_torch.strategies  # noqa: F401  (populate the registries)
from repro_torch.api.registry import get_registry
from repro_torch.api.scenario import FleetSpec
from repro_torch.core.faults import FaultSpec

SPEC_VERSION = 1

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

    # ---- wireless fleet / physical scenario --------------------------
    bandwidth_mhz: float = 20.0            # B (per cell, reused by cells)
    fleet: Optional[Any] = None            # FleetSpec (or its dict form);
                                           # None → the paper's §VI single
                                           # cell (sample_fleet, the same
                                           # draws as FleetSpec())

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
    fedprox_mu: float = 0.0                # >0 → FedProx client objective

    # ---- client parameter store (population-scale fleets) ------------
    store: str = "dense"                   # "dense": the [N, P] device plane;
                                           # "paged": the active plane on the
                                           # device, the rest in a host cold
                                           # store (repro_torch.core.store)
    k_max: Optional[int] = None            # active-plane rows (paged);
                                           # None → max(S, 256) capped at N
    chunk_size: Optional[int] = None       # cold-store block rows (paged);
                                           # None → ~64 MB blocks
    div_refresh_every: int = 0             # paged divergence refresh cadence:
                                           # 1 = every selection (the dense
                                           # signal), 0 = lazy (drift-bounded)
    cluster: str = "full"                  # Alg.-2 K-means fit: "full" (one
                                           # [N, F] matrix) or "minibatch"
                                           # (streamed, O(chunk) memory)

    # ---- flat-plane sharding (model axis) ----------------------------
    p_shards: int = 0                      # >0: lay the [N, P] plane's P
                                           # axis over min(p_shards, devices)
                                           # (repro_torch.sharding.specs);
                                           # 0 = off

    # ---- client churn (the paged store's round loop, or the tick of
    # the buffered-asynchronous engine: an async-capable aggregator,
    # aggregator="fedbuff:M[:alpha]", on either store) ------------------
    churn_leave: float = 0.0               # per-round P(available → gone)
    churn_join: float = 0.0                # per-round P(gone → available)

    # ---- fault injection / robustness (repro_torch.core.faults) -------
    faults: Optional[Any] = None           # FaultSpec, its dict form, or the
                                           # compact "outage:0.1,corrupt:0.01"
                                           # string; None → fault-free
    quarantine_after: int = 0              # strikes (non-finite uploads)
                                           # before a client is excluded from
                                           # selection like avail=False; 0=off

    # ---- cohort (seeds as lanes of one captured round) ---------------
    cohort: int = 1                        # seeds seed..seed+cohort-1 run as
                                           # ONE program (build_cohort)

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
    compressor: StrategyRef = "none"

    version: int = SPEC_VERSION

    def __post_init__(self):
        if self.store not in ("dense", "paged"):
            raise ValueError(f"store={self.store!r}: expected 'dense' or "
                             "'paged'")
        for name in ("k_max", "chunk_size"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive; got {v}")
        if self.div_refresh_every < 0:
            raise ValueError("div_refresh_every must be >= 0; got "
                             f"{self.div_refresh_every}")
        if self.cluster not in ("full", "minibatch"):
            raise ValueError(f"cluster={self.cluster!r}: expected 'full' "
                             "or 'minibatch'")
        if self.p_shards < 0:
            raise ValueError(f"p_shards must be >= 0; got {self.p_shards}")
        for name in ("churn_leave", "churn_join"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} is a per-round probability; "
                                 f"expected 0 <= p <= 1, got {v}")
        if self.model not in ("auto", "cnn"):
            from repro_torch.models.registry import workload_names
            if self.model not in workload_names():
                raise ValueError(f"unknown model {self.model!r}; known: "
                                 f"{('auto', 'cnn') + workload_names()}")
        if self.fleet is not None and not isinstance(self.fleet, FleetSpec):
            object.__setattr__(self, "fleet", FleetSpec.from_dict(self.fleet))
        if self.quarantine_after < 0:
            raise ValueError("quarantine_after must be >= 0; got "
                             f"{self.quarantine_after}")
        object.__setattr__(self, "faults", FaultSpec.normalize(self.faults))
        for name, kind in (("selection", "selector"),
                           ("allocator", "allocator"),
                           ("aggregator", "aggregator"),
                           ("compressor", "compressor")):
            object.__setattr__(self, name, get_registry(kind).canonical(
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

    @property
    def resolved_fleet_spec(self) -> FleetSpec:
        """The scenario, ``None`` resolved to the paper's single static
        cell."""
        return self.fleet if self.fleet is not None else FleetSpec()

    @property
    def num_cells(self) -> int:
        return 1 if self.fleet is None else self.fleet.num_cells

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)

    # ---- serialization -----------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        version = d.pop("version", SPEC_VERSION)
        if version > SPEC_VERSION:
            raise ValueError(f"spec version {version} is newer than "
                             f"supported {SPEC_VERSION}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ExperimentSpec fields: "
                             f"{sorted(unknown)}")
        return cls(version=version, **d)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

