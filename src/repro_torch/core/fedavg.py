"""Federated-learning loop — paper Algorithm 1 + the Fig. 2 framework, as
the synchronous host loop over the dense ``[N, P]`` client plane.

Per round k:
  1. device selection        — Algorithm 4 on the weight divergences, or
                               a compared policy (``SELECTORS``)
  2. spectrum allocation     — SAO, Algorithm 5, or a §VI-A baseline
                               (``ALLOCATORS``)
  3. local updates (L SGD steps each), all selected clients at once
  4. weighted aggregation    — eq. (4), one ``flat_aggregate`` fold
  5. bookkeeping: accuracy, T_k, E_k (eqs. 10-11)

Clustering (Algorithm 2) happens once, after an initial all-device round,
on the K-means features of the paper's chosen layer.

``FLExperiment`` owns the experiment's state on one device — the global
row, the client plane, the data — one draws object
(``repro_torch.core.draws``) that the model's random choices come from,
and the host Generator ``rng`` that the stochastic selectors draw from.
Build it from a declarative spec with ``repro_torch.api.build_experiment``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

import repro_torch.strategies  # noqa: F401  (populate the registries)
from repro_torch.api.protocols import Allocation, SelectionContext
from repro_torch.api.registry import AGGREGATORS, ALLOCATORS, SELECTORS
from repro_torch.configs.base import FLConfig
from repro_torch.core.clustering import (clusters_from_labels,
                                         extract_features_flat, kmeans_fit)
from repro_torch.core.divergence import weight_divergence_flat
from repro_torch.core.draws import TorchDraws
from repro_torch.core.engine import RoundEngine
from repro_torch.core.wireless import Fleet, fleet_arrays
from repro_torch.data.partition import FederatedData
from repro_torch.models.registry import model_def_for
from repro_torch.utils.trees import flatten_vector


@dataclass
class RoundResult:
    """Everything one round produces (paper bookkeeping: eqs. 4, 10-11)."""
    selected: np.ndarray              # device indices that participated
    T_k: float                        # round delay [s]
    E_k: float                        # round energy [J]
    accuracy: float                   # test accuracy after aggregation
                                      # (next-token accuracy for the LM)
    per_class: np.ndarray             # per-class (per-dialect) accuracy
    band_mhz: float = 0.0             # Σ b_n of the round's allocation


@dataclass
class FLHistory:
    accuracy: List[float] = field(default_factory=list)
    T_k: List[float] = field(default_factory=list)
    E_k: List[float] = field(default_factory=list)
    selected: List[np.ndarray] = field(default_factory=list)
    rounds_to_target: Optional[int] = None
    band_mhz: List[float] = field(default_factory=list)   # Σ b_n per round
    seconds: List[float] = field(default_factory=list)    # host wall clock
    per_class: List[np.ndarray] = field(default_factory=list)

    def append(self, res: RoundResult, seconds: float):
        self.accuracy.append(float(res.accuracy))
        self.per_class.append(np.asarray(res.per_class))
        self.T_k.append(float(res.T_k))
        self.E_k.append(float(res.E_k))
        self.selected.append(np.asarray(res.selected))
        self.band_mhz.append(float(res.band_mhz))
        self.seconds.append(seconds)


def fp32_matmuls() -> None:
    """Keep float32 products in full float32: PyTorch's cuDNN default runs
    fp32 convolutions in TF32 (about three decimal digits), which the
    reference never does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class FLExperiment:
    """The synchronous dense FL loop on one device, driven from the host.

    ``selection``, ``allocator`` and ``aggregator`` take a registered name,
    the ``name:arg`` shorthand, a ``{"name", "params"}`` dict or an
    instance; ``box_correct=True`` turns on the ``sao`` allocator's KKT box
    correction (and raises for any other allocator). ``seed`` seeds the
    selectors' host Generator ``rng`` and the default draws.

    ``draws`` replaces the default :class:`TorchDraws` (seeded with
    ``seed``): a parity test hands in a replay of the reference's key
    stream. The client plane and the global row live on ``device``; the
    plane is updated in place each round, as the reference's donated
    scatter does. A workload with frozen weights (the LoRA LM) gets them
    from ``draws.base_params`` and, as it uploads only its trainable rows,
    prices the fleet's payload at ``z = P·32/1e6`` Mbit.
    """

    def __init__(self, model_cfg, fed: FederatedData, test_images: np.ndarray,
                 test_labels: np.ndarray, fleet: Fleet, fl: FLConfig, *,
                 device, bandwidth_mhz: float = 20.0, seed: int = 0,
                 batch_size: int = 32, selection=None, allocator="sao",
                 aggregator="fedavg", box_correct: bool = False,
                 draws=None):
        fp32_matmuls()
        self.device = torch.device(device)
        self.model_cfg = model_cfg
        self.fed = fed
        self.fleet = fleet
        self.fl = fl
        self.B = bandwidth_mhz
        self.rng = np.random.default_rng(seed)
        self.selector = SELECTORS.resolve(selection if selection is not None
                                          else fl.selection)
        self.allocator = ALLOCATORS.resolve(allocator)
        if box_correct:
            if getattr(self.allocator, "registry_name", "") != "sao":
                raise ValueError("box_correct=True only applies to the "
                                 "'sao' allocator; set allocator params "
                                 "explicitly instead")
            self.allocator = dataclasses.replace(self.allocator,
                                                 box_correct=True)
        self.aggregator = AGGREGATORS.resolve(aggregator)
        self.draws = draws if draws is not None else TorchDraws(seed,
                                                                self.device)
        mdef = model_def_for(model_cfg)
        self.base = (self.draws.base_params(model_cfg)
                     if mdef.base is not None else None)
        self.engine = RoundEngine(model_cfg, fl.learning_rate,
                                  fl.local_iters, batch_size, self.base)
        self.batch_size = batch_size

        spec = self.engine.flat_spec
        params = self.draws.init_params(model_cfg)
        self.global_vec = flatten_vector(spec, params).to(self.device)
        self.client_plane = self.global_vec.repeat(fed.num_clients, 1)
        if mdef.price_uploads:
            self.fleet = dataclasses.replace(
                fleet, z=np.full_like(fleet.z, spec.total * 32 / 1e6))

        def put(x):
            # token windows stay integer; images are float32
            x = np.asarray(x)
            dtype = (torch.long if np.issubdtype(x.dtype, np.integer)
                     else torch.float32)
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        self.test_images = put(test_images)
        self.test_labels = put(test_labels)
        self._images = put(fed.images)
        self._labels = put(fed.labels)
        self._sizes = put(fed.sizes)
        self.clusters: Optional[List[np.ndarray]] = None
        self.cluster_labels: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx), dtype=torch.long,
                               device=self.device)

    def evaluate(self):
        acc, per_class = self.engine.evaluate(
            self.global_vec, self.test_images, self.test_labels)
        return float(acc), per_class.cpu().numpy()

    def _batch_indices(self, n: int) -> torch.Tensor:
        return self.draws.batch_indices(n, self.fl.local_iters,
                                        self.batch_size,
                                        self._images.shape[1])

    def train_clients(self, idx) -> torch.Tensor:
        """Local updates of ``idx`` from the global row -> ``[S, P]``."""
        t = self._index(idx)
        return self.engine.train_clients(
            self.global_vec, self._images[t], self._labels[t],
            self._batch_indices(len(t)))

    def store_clients(self, rows: torch.Tensor, idx) -> None:
        """Write the clients' rows into the plane, in place."""
        self.client_plane.index_copy_(0, self._index(idx), rows)

    def aggregate(self, rows: torch.Tensor, idx) -> None:
        """Eq. (4) over the participating rows."""
        self.global_vec = self.aggregator.aggregate_flat(
            self.global_vec, rows, self._sizes[self._index(idx)])

    def client_features(self, layer: Optional[str] = None) -> torch.Tensor:
        """K-means feature matrix ``[N, F]`` (Alg. 2's input): a column
        view of the plane."""
        layer = self.fl.feature_layer if layer is None else layer
        return extract_features_flat(self.client_plane, layer,
                                     self.engine.flat_spec)

    # ------------------------------------------------------------------
    def initial_round(self) -> None:
        """Round 0: all devices train; then K-means clustering (Alg. 2)."""
        idx = np.arange(self.fed.num_clients)
        rows = self.train_clients(idx)
        self.store_clients(rows, idx)
        self.aggregate(rows, idx)
        _, labels, _ = kmeans_fit(self.client_features(),
                                  self.fl.num_clusters, draws=self.draws)
        self.cluster_labels = labels.cpu().numpy()
        self.clusters = clusters_from_labels(self.cluster_labels,
                                             self.fl.num_clusters)

    def divergences(self) -> np.ndarray:
        """Per-client ‖w_n − w_g‖ — the §IV-C selection signal, one row
        reduction over the plane."""
        return weight_divergence_flat(self.client_plane,
                                      self.global_vec).cpu().numpy()

    def selection_context(self) -> SelectionContext:
        return SelectionContext(
            rng=self.rng,
            num_devices=self.fed.num_clients,
            devices_per_round=self.fl.devices_per_round,
            selected_per_cluster=self.fl.selected_per_cluster,
            bandwidth_mhz=self.B,
            fleet=self.fleet,
            clusters=self.clusters,
            divergences=self.divergences)

    def select(self, method=None) -> np.ndarray:
        """Device selection for one round; ``method`` is a registered name,
        a spec dict, a selector instance, or None for the experiment's
        own selector."""
        selector = (self.selector if method is None
                    else SELECTORS.resolve(method))
        return np.asarray(selector.select(self.selection_context()))

    def allocation(self, idx) -> Allocation:
        """Spectrum allocation for the selected devices."""
        arr = fleet_arrays(self.fleet.select(np.asarray(idx)), self.device)
        return self.allocator.allocate(arr, self.B)

    def allocate(self, idx):
        a = self.allocation(idx)
        return a.T, a.E

    def round(self, method=None) -> RoundResult:
        """One full FL round: select → allocate → train → aggregate → eval,
        each phase a profiler span (``fl.select`` …). ``method`` picks the
        selector as in :meth:`select`. A selection that comes back empty
        is an explicit no-op round: nothing trains, T_k = E_k = 0."""
        with record_function("fl.select"):
            idx = self.select(method)
        if idx.size == 0:
            acc, per_class = self.evaluate()
            return RoundResult(selected=idx, T_k=0.0, E_k=0.0, accuracy=acc,
                               per_class=per_class)
        with record_function("fl.allocate"):
            alloc = self.allocation(idx)
        t = self._index(idx)
        rows, new_global, acc, per_class = self.engine.round_step(
            self.global_vec, self._images[t], self._labels[t],
            self._batch_indices(len(t)), self._sizes[t], self.test_images,
            self.test_labels, self.aggregator)
        self.store_clients(rows, idx)
        self.global_vec = new_global
        return RoundResult(selected=idx, T_k=float(alloc.T),
                           E_k=float(alloc.E), accuracy=float(acc),
                           per_class=per_class.cpu().numpy(),
                           band_mhz=float(torch.sum(alloc.b)))

    def run(self, method=None, rounds: Optional[int] = None,
            target_accuracy: Optional[float] = None) -> FLHistory:
        """The host round loop: the initial round (recorded as round 0,
        all devices), then ``rounds`` rounds of :meth:`round` with
        ``method``, stopping early once the test accuracy reaches
        ``target_accuracy`` (0 = never)."""
        rounds = rounds or self.fl.max_rounds
        target = (self.fl.target_accuracy
                  if target_accuracy is None else target_accuracy)
        hist = FLHistory()
        t0 = time.perf_counter()
        self.initial_round()
        acc, per_class = self.evaluate()
        all_idx = np.arange(self.fed.num_clients)
        a = self.allocation(all_idx)
        hist.append(RoundResult(
            selected=all_idx, T_k=float(a.T), E_k=float(a.E), accuracy=acc,
            per_class=per_class, band_mhz=float(torch.sum(a.b))),
            time.perf_counter() - t0)
        for k in range(rounds):
            t0 = time.perf_counter()
            res = self.round(method)
            hist.append(res, time.perf_counter() - t0)
            if target and res.accuracy >= target:
                hist.rounds_to_target = k + 1
                break
        return hist
