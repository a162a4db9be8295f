"""Federated-learning loop — paper Algorithm 1 + the Fig. 2 framework, over
a client store (``repro_torch.core.store``): the dense ``[N, P]`` plane on
the device, by one of two paths that give the same results:

* the device-resident run (``repro_torch.core.engine.run_rounds``): the
  whole experiment's rounds as one round body on the device — on the card
  a captured CUDA graph replayed once a round, with no host read until
  the history comes back in one transfer — taken by :meth:`run` when the
  selector is deterministic, every strategy is traceable and no accuracy
  target asks for an early stop (a stochastic selector runs there only
  when the caller supplies the draws: :meth:`traced_run`, and the cohort,
  ``repro_torch.core.cohort``, which stacks experiments as lanes);
* the host loop (:meth:`FLExperiment.round`), one round at a time with
  the strategies' host contracts in between, each round the same round
  body (``build_round_phases``'s ``finish_phase``) run eagerly on the
  experiment's own state.

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

With ``store="paged"`` (a population-scale fleet, N ≫ K) the clients' rows
live in a cold store in host memory and the host loop runs each round on
the active plane alone: the K selected rows gathered to the device as the
round body's plane (indices local, 0..K−1), written back after it. The
O(N) state is the per-client stats table, which serves the divergence
signal (refreshed every ``div_refresh_every`` rounds, else bounded by its
drift) and the churn mask. An initial round of more than ``k_max``
clients trains in waves whose mean streams to the host.

An async-capable aggregator (``fedbuff:M[:alpha]``) runs buffered-
asynchronous ticks (``repro_torch.core.async_engine``) in place of
rounds, with churn inside the tick: on the dense store the device-
resident run (one captured tick, replayed), on the paged store a host
composition of the tick's four pieces (:meth:`FLExperiment.
_run_async_paged`). The scheduler's columns ride the stats table, so a
second ``run()`` continues the virtual clock.

``FLExperiment`` owns the experiment's state on one device — the global
row, the client plane, the data, the K-means labels — one draws object
(``repro_torch.core.draws``) that the model's random choices come from,
and the host Generator ``rng`` that the stochastic selectors draw from.
Build it from a declarative spec with ``repro_torch.api.build_experiment``.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

import repro_torch.strategies  # noqa: F401  (populate the registries)
from repro_torch.api.protocols import (Allocation, RoundState,
                                       SelectionContext, TracedContext)
from repro_torch.api.registry import (AGGREGATORS, ALLOCATORS, CHANNELS,
                                      COMPRESSORS, SELECTORS)
from repro_torch.configs.base import FLConfig
from repro_torch.core.async_engine import parse_churn
from repro_torch.core.clustering import (clusters_from_labels,
                                         extract_features_flat, kmeans_fit,
                                         kmeans_fit_minibatch,
                                         resolve_feature_columns)
from repro_torch.core.divergence import weight_divergence_flat
from repro_torch.core.draws import TorchDraws
from repro_torch.core.faults import (FaultSpec, byzantine_clients,
                                     draw_fault_masks)
from repro_torch.core.engine import (EngineConfig, RoundInputs,
                                     RoundOutputs, TracedRunResult,
                                     build_round_phases, model_flat_spec,
                                     run_rounds, selector_draw_kind)
from repro_torch.core.store import ClientStats, build_store
from repro_torch.core.wireless import Fleet, fleet_arrays
from repro_torch.data.partition import FederatedData
from repro_torch.kernels import ops
from repro_torch.kernels.chunked import (default_chunk_size,
                                         streaming_weighted_mean)
from repro_torch.models.registry import model_def_for
from repro_torch.sharding import specs as sh
from repro_torch.sharding.blocks import ColumnBlocks
from repro_torch.utils.spans import span
from repro_torch.utils.trees import (flatten_stacked, flatten_vector,
                                     unflatten_rows_np)

#: ``_rounds_since_refresh`` after a mass write that set no divergence
#: (the initial round): the next ``divergences()`` refreshes every touched
#: row, whatever ``div_refresh_every`` says
FORCE_REFRESH = int(np.iinfo(np.int32).max)


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
    # host wall clock per round; empty after a device-resident run, whose
    # rounds have no host boundary of their own to time
    seconds: List[float] = field(default_factory=list)
    per_class: List[np.ndarray] = field(default_factory=list)
    # the buffered-asynchronous engine's per-tick traces (empty on a
    # synchronous run): updates folded, their mean age at the fold, the
    # available fleet's size
    participation: List[float] = field(default_factory=list)
    staleness: List[float] = field(default_factory=list)
    active: List[float] = field(default_factory=list)

    _ROUNDS = ("accuracy", "T_k", "E_k", "selected", "band_mhz", "seconds",
               "per_class", "participation", "staleness", "active")

    @property
    def total_T(self) -> float:
        return float(np.sum(self.T_k))

    @property
    def total_E(self) -> float:
        return float(np.sum(self.E_k))

    def append(self, res: RoundResult, seconds: Optional[float] = None):
        self.accuracy.append(float(res.accuracy))
        self.per_class.append(np.asarray(res.per_class))
        self.T_k.append(float(res.T_k))
        self.E_k.append(float(res.E_k))
        self.selected.append(np.asarray(res.selected))
        self.band_mhz.append(float(res.band_mhz))
        if seconds is not None:
            self.seconds.append(seconds)

    def extend(self, other: "FLHistory") -> "FLHistory":
        """``other``'s rounds after this history's (a resumed run's rounds
        after the restored prefix)."""
        for name in self._ROUNDS:
            getattr(self, name).extend(getattr(other, name))
        if self.rounds_to_target is None:
            self.rounds_to_target = other.rounds_to_target
        return self

    def to_dict(self) -> dict:
        """The JSON form (a checkpoint's manifest)."""
        d = {name: [float(x) for x in getattr(self, name)]
             for name in self._ROUNDS
             if name not in ("selected", "per_class")}
        d["selected"] = [np.asarray(s).tolist() for s in self.selected]
        d["per_class"] = [np.asarray(p).tolist() for p in self.per_class]
        d["rounds_to_target"] = self.rounds_to_target
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FLHistory":
        hist = cls(rounds_to_target=d.get("rounds_to_target"))
        for name in cls._ROUNDS:
            getattr(hist, name).extend(d.get(name, []))
        hist.selected = [np.asarray(s, np.int64) for s in hist.selected]
        hist.per_class = [np.asarray(p, np.float32) for p in hist.per_class]
        return hist


class _Checkpointer:
    """The ``run()`` checkpoint knobs for the host loops: a snapshot every
    ``every`` completed rounds, counted from ``offset`` so a resumed run
    keeps the original round numbers."""

    def __init__(self, exp: "FLExperiment", directory: str, every: int,
                 offset: int, spec_dict: Optional[dict]):
        if every <= 0:
            raise ValueError(f"checkpoint_every must be > 0; got {every}")
        self.exp = exp
        self.directory = directory
        self.every = every
        self.offset = offset
        self.spec_dict = spec_dict

    def due(self, k: int) -> bool:
        return (self.offset + k + 1) % self.every == 0

    def save(self, k: int, hist: FLHistory) -> str:
        return self.exp.save_checkpoint(
            self.directory, self.offset + k + 1, history=hist,
            spec_dict=self.spec_dict)

    def maybe(self, k: int, hist: FLHistory) -> None:
        if self.due(k):
            self.save(k, hist)


def fp32_matmuls() -> None:
    """Keep float32 products in full float32: PyTorch's cuDNN default runs
    fp32 convolutions in TF32 (about three decimal digits), which the
    reference never does. bf16 products keep their fp32 accumulation
    whole too (no reduced-precision split-K sums), as the reference's bf16
    dots accumulate in fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class FLExperiment:
    """The synchronous FL loop on one device, driven from the host.

    ``selection``, ``allocator``, ``aggregator``, ``compression`` and
    ``channel`` take a registered name, the ``name:arg`` shorthand, a
    ``{"name", "params"}`` dict or an instance; ``box_correct=True`` turns
    on the ``sao`` allocator's KKT box correction (and raises for any
    other allocator); ``aggregator=None`` is ``fedavgm:<server_momentum>``
    when ``server_momentum > 0``, else ``fedavg``. A lossy compressor
    prices the fleet's payload z_n at its ``payload_mbit`` (SAO reads it
    through H = z·p and t_com). A fading ``channel`` redraws the gains
    inside the device-resident run only. ``seed`` seeds the selectors'
    host Generator ``rng`` and the default draws.

    ``draws`` replaces the default :class:`TorchDraws` (seeded with
    ``seed``): a parity test hands in a replay of the reference's key
    stream. The client plane and the global row live on ``device``; the
    plane is updated in place each round, as the reference's donated
    scatter does. ``fedprox_mu > 0`` trains each client on the FedProx
    objective (``repro_torch.core.algorithms``). A workload with frozen
    weights (the LoRA LM) gets them from ``draws.base_params`` and, as it
    uploads only its trainable rows, prices the fleet's payload at
    ``z = P·32/1e6`` Mbit.

    ``store`` is the client store: ``"dense"`` (the plane on ``device``)
    or ``"paged"`` (the host cold store; ``k_max`` rows at most on the
    device at once, default ``min(N, max(S, 256))``; ``chunk_size`` rows a
    cold block, default ``default_chunk_size(P)``, ~64 MB;
    ``div_refresh_every`` rounds between refreshes of the touched rows'
    divergences, 0 = never after the first, the signal then bounded by
    ``stats.drift``). ``cluster`` fits Alg. 2's K-means on one ``[N, F]``
    matrix (``"full"``) or streams it a chunk at a time
    (``"minibatch"``). ``churn`` (``(p_leave, p_join)``) flips the stats
    table's availability mask before every round of :meth:`run` on the
    paged store, and inside every tick of an async-capable aggregator on
    either store. Index-backed data (``LazyFederatedData``) needs the paged
    store; its rounds gather their clients' images from the pool on the
    device.

    ``faults`` (a ``FaultSpec``, its dict or compact string,
    ``repro_torch.core.faults``) injects failures into every selection
    round or tick on every path, and ``quarantine_after > 0`` keeps a
    client with that many strikes (non-finite uploads) out of selection;
    the stats table's ``faults`` and ``strikes`` count them. ``run(
    checkpoint_every=, checkpoint_dir=)`` snapshots the host loops
    (:meth:`save_checkpoint`); :meth:`load_checkpoint` resumes a fresh
    experiment from one, bit for bit.

    ``p_shards > 0`` lays the device-resident run's carry on a ``model``
    mesh of ``min(p_shards, devices)`` positions (``sharding.specs.
    plane_mesh``): the ``[N + S_pad, P]`` plane as ``plane_split`` column
    blocks, one a position (``sharding.blocks.ColumnBlocks``), every
    other leaf whole on the lead position. ``plane_split`` is 1 — the
    plane whole on the lead — on one position, where ``P`` does not
    divide (the reference's ``plane_spec`` replicates then), and for the
    buffered-asynchronous tick, which reads its candidates' rows back
    from the plane. The experiment keeps the blocks between runs; the
    host loop, which ignores ``p_shards`` as the reference's does, joins
    them first.
    """

    def __init__(self, model_cfg, fed: FederatedData, test_images: np.ndarray,
                 test_labels: np.ndarray, fleet: Fleet, fl: FLConfig, *,
                 device, bandwidth_mhz: float = 20.0, seed: int = 0,
                 batch_size: int = 32, selection=None, allocator="sao",
                 aggregator=None, compression="none", channel="static",
                 server_momentum: float = 0.0, box_correct: bool = False,
                 fedprox_mu: float = 0.0, draws=None, churn=None,
                 store: str = "dense", k_max: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 div_refresh_every: int = 0, cluster: str = "full",
                 faults=None, quarantine_after: int = 0, p_shards: int = 0):
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
        if aggregator is None:
            aggregator = (f"fedavgm:{server_momentum}"
                          if server_momentum > 0 else "fedavg")
        self.aggregator = AGGREGATORS.resolve(aggregator)
        self.aggregator.reset()
        self.compressor = COMPRESSORS.resolve(compression)
        self.channel = CHANNELS.resolve(channel)
        self.churn = parse_churn(churn)
        if (self.churn != (0.0, 0.0) and store != "paged"
                and not getattr(self.aggregator, "async_capable", False)):
            raise ValueError(
                "client churn needs an engine that tracks availability: "
                "the paged client store (store='paged'), whose round loop "
                "flips the stats table's availability mask, or the "
                "buffered-asynchronous engine (an async-capable aggregator, "
                "e.g. 'fedbuff:4')")
        if cluster not in ("full", "minibatch"):
            raise ValueError(
                f"cluster must be 'full' or 'minibatch'; got {cluster!r}")
        self.cluster_mode = cluster
        self.draws = draws if draws is not None else TorchDraws(seed,
                                                                self.device)
        self.faults = FaultSpec.normalize(faults)
        self.quarantine_after = int(quarantine_after)
        if self.quarantine_after < 0:
            raise ValueError("quarantine_after must be >= 0; got "
                             f"{quarantine_after}")
        self.p_shards = int(p_shards)
        self.plane_mesh = sh.plane_mesh(self.p_shards, self.device)
        if (self.faults is not None and self.faults.chan_outage > 0.0
                and not getattr(self.channel, "stateful", False)):
            raise ValueError(
                "faults: chan_outage derives upload failures from the "
                "Gauss-Markov fade state and needs a stateful channel "
                "(e.g. channel='gauss-markov'); got "
                f"{self.channel.registry_name!r}")
        self._byz_mask = (byzantine_clients(self.faults, fed.num_clients,
                                            self.draws)
                          if self._faults_on and self.faults.byzantine > 0.0
                          else None)
        mdef = model_def_for(model_cfg)
        self.base = (self.draws.base_params(model_cfg)
                     if mdef.base is not None else None)
        self.engine_cfg = EngineConfig(model_cfg, fl.learning_rate,
                                       fl.local_iters, batch_size, fedprox_mu)
        self.flat_spec = spec = model_flat_spec(model_cfg)
        self._ph = None
        self.program = None       # the last device-resident run's program
        self.batch_size = batch_size

        params = self.draws.init_params(model_cfg)
        self.global_vec = flatten_vector(spec, params).to(self.device)
        n = fed.num_clients
        self.chunk_size = int(chunk_size or default_chunk_size(spec.total))
        self.k_max = int(k_max or min(n, max(fl.devices_per_round, 256)))
        self._store = build_store(store, self.global_vec, n, self.chunk_size,
                                  stage_rows=self.k_max)
        mesh = self.plane_mesh
        split = mesh is not None and any(
            e is not None for e in sh.plane_spec(
                torch.empty((n, spec.total), device="meta"), mesh,
                spec.total))
        self.plane_split = (mesh.size if split and store == "dense"
                            and not getattr(self.aggregator, "async_capable",
                                            False)
                            else 1)
        self._div_refresh_every = int(div_refresh_every)
        self._rounds_since_refresh = FORCE_REFRESH
        # the global row the stats table's drift is measured from
        self._gvec_host = (self.global_vec.to("cpu", copy=True).numpy()
                           if store == "paged" else None)
        # a lossy uplink shrinks the payload; an adapter workload uploads
        # its trainable rows only, never its frozen base
        z = self.compressor.payload_mbit(spec.total, len(spec.names))
        if z is None and mdef.price_uploads:
            z = spec.total * 32 / 1e6
        if z is not None:
            self.fleet = dataclasses.replace(fleet,
                                             z=np.full_like(fleet.z, z))

        def put(x):
            # token windows stay integer; images are float32
            x = np.asarray(x)
            dtype = (torch.long if np.issubdtype(x.dtype, np.integer)
                     else torch.float32)
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        self.test_images = put(test_images)
        self.test_labels = put(test_labels)
        if getattr(fed, "lazy", False):
            # per-client sample indices into a shared pool: a round
            # gathers its clients' images from the pool on the device
            if store != "paged":
                raise ValueError(
                    "lazy federated data (index-backed partition) requires "
                    "store='paged'; the dense and traced paths consume the "
                    "materialized [N, D, ...] image stack")
            self._pool_images = put(fed.pool_images)
            self._images = None
        else:
            self._pool_images = None
            self._images = put(fed.images)
        # the paged store keeps the [N, D] labels as they come (int32: half
        # the bytes of int64 at N = 1e6) and widens a round's rows
        self._labels = (torch.as_tensor(fed.labels, device=self.device)
                        if store == "paged" else put(fed.labels))
        self._sizes = put(fed.sizes)
        self._sizes_host = np.asarray(fed.sizes)
        self._num_samples = fed.labels.shape[1]
        self.clusters: Optional[List[np.ndarray]] = None
        self.cluster_labels: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    @property
    def store(self):
        """The client store (``DenseStore`` | ``PagedStore``)."""
        return self._store

    @property
    def stats(self) -> ClientStats:
        """The O(N) per-client statistics table, owned by the store."""
        return self._store.stats

    @property
    def _faults_on(self) -> bool:
        return self.faults is not None and self.faults.active

    @property
    def _track_faults(self) -> bool:
        return self._faults_on or self.quarantine_after > 0

    def _fault_args(self) -> dict:
        """The round body's fault arguments (``build_round_phases``)."""
        return dict(faults=self.faults,
                    quarantine_after=self.quarantine_after,
                    byzantine=self._byz_mask)

    @property
    def client_plane(self) -> torch.Tensor:
        """The dense ``[N, P]`` plane on the device (updated in place by
        the round loop). After a run with ``plane_split > 1`` the
        experiment keeps the plane as its column blocks, and this is a
        whole copy assembled on the lead. A paged store keeps none: gather
        the rows you need through the store instead."""
        if self._store.kind != "dense":
            raise AttributeError(
                "store='paged' keeps no [N, P] client buffer; gather "
                "active rows with exp.store.gather(idx), page the cold "
                "store with iter_client_trees()/iter_client_features(), "
                "or read the O(N) exp.stats table")
        buf = self._store.buffer
        return buf.assemble() if isinstance(buf, ColumnBlocks) else buf

    def _whole_plane(self) -> torch.Tensor:
        """The dense plane as one tensor the host loop updates in place:
        column blocks are joined on the lead first, and stay joined."""
        buf = self._store.buffer
        if isinstance(buf, ColumnBlocks):
            buf = self._store.buffer = buf.assemble()
        return buf

    @client_plane.setter
    def client_plane(self, value: torch.Tensor) -> None:
        if self._store.kind != "dense":
            raise AttributeError(
                "store='paged' keeps no [N, P] client buffer to assign; "
                "persist trained rows through exp.store.scatter(idx, rows)")
        self._store.buffer = value

    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx), dtype=torch.long,
                               device=self.device)

    def _client_data(self, idx):
        """The clients ``idx``'s ``(images, labels, sizes)`` on the device:
        a row gather, or for index-backed data a gather from the pool."""
        g = self._index(idx)
        if self._pool_images is None:
            images = self._images[g]
        else:
            images = self._pool_images[self._index(
                self.fed.indices[np.asarray(idx)])]
        return images, self._labels[g].long(), self._sizes[g]

    def phases(self):
        """The round body (``build_round_phases``) for the experiment's
        current allocator and aggregator, rebuilt when either is
        swapped."""
        ph = self._ph
        if (ph is None or ph.allocator is not self.allocator
                or ph.aggregator is not self.aggregator):
            ph = self._ph = build_round_phases(
                self.engine_cfg, self.aggregator, self.selector,
                self.allocator, self.traced_context(),
                self.fl.feature_layer, self.base,
                compressor=self.compressor, channel=self.channel,
                plane="rows", **self._fault_args())
        return ph

    def _host_state(self) -> RoundState:
        """The experiment's own state as the round body's carry: the
        global row and the plane themselves (updated in place), the
        aggregator's state and the K-means labels; under faults or
        quarantine a device copy of the stats table (:meth:`_round`
        copies its counts back)."""
        return RoundState(params=self.global_vec,
                          client_params=self._whole_plane(),
                          opt_state=self.aggregator.init_flat_state(
                              self.global_vec),
                          labels=self._labels_tensor(),
                          sched=(self.stats.device(self.device)
                                 if self._track_faults else None))

    def _labels_tensor(self) -> torch.Tensor:
        n = self.fed.num_clients
        if self.cluster_labels is None:
            return torch.zeros((n,), dtype=torch.long, device=self.device)
        return torch.as_tensor(self.cluster_labels, dtype=torch.long,
                               device=self.device)

    def evaluate(self):
        acc, per_class = self.phases().evaluate_row(
            self.global_vec, self.test_images, self.test_labels)
        return float(acc), per_class.cpu().numpy()

    def _batch_indices(self, n: int) -> torch.Tensor:
        """``[n, L, batch]`` sample indices: one draw for the clients of one
        training call (a round's K, a wave's), never the fleet's."""
        return self.draws.batch_indices(n, self.fl.local_iters,
                                        self.batch_size, self._num_samples)

    def _chunk(self, chunk_size: Optional[int]) -> int:
        return int(chunk_size) if chunk_size else self.chunk_size

    def client_features(self, layer: Optional[str] = None,
                        chunk_size: Optional[int] = None) -> torch.Tensor:
        """K-means feature matrix ``[N, F]`` (Alg. 2's input) on the
        device: a column view of the dense plane, or assembled from the
        paged store ``chunk_size`` rows at a time (the same columns), so
        only the ``[N, F]`` block ever exists."""
        layer = self.fl.feature_layer if layer is None else layer
        if self._store.kind == "dense":
            return extract_features_flat(self.client_plane, layer,
                                         self.flat_spec)
        blocks = [blk for _, blk in self.iter_client_features(layer,
                                                              chunk_size)]
        return torch.as_tensor(np.concatenate(blocks, axis=0)).to(
            self.device)

    def iter_client_features(self, layer: Optional[str] = None,
                             chunk_size: Optional[int] = None):
        """``(start_row, [c, F] host feature block)`` pairs — the
        O(chunk·P) stream form of :meth:`client_features`."""
        layer = self.fl.feature_layer if layer is None else layer
        cols = resolve_feature_columns(self.flat_spec, layer)
        start = 0
        for block in self._store.iter_chunks(self._chunk(chunk_size)):
            yield start, block if cols is None else block[:, cols]
            start += block.shape[0]

    def client_tree(self, chunk_size: Optional[int] = None):
        """The client store as ``{name: [N, ...]}`` host arrays — a COPY,
        assembled ``chunk_size`` rows at a time (beyond the O(N·P)
        result, one chunk): :meth:`iter_client_trees` streams it."""
        spec = self.flat_spec
        n = self.fed.num_clients
        leaves = {name: np.empty((n,) + shape, dt)
                  for name, shape, dt in zip(spec.names, spec.shapes,
                                             spec.dtypes)}
        for start, tree in self.iter_client_trees(chunk_size):
            for name, leaf in tree.items():
                leaves[name][start:start + leaf.shape[0]] = leaf
        return leaves

    def iter_client_trees(self, chunk_size: Optional[int] = None):
        """``(start_row, {name: [c, ...]})`` blocks of at most
        ``chunk_size`` clients — O(chunk·P) at a time."""
        start = 0
        for block in self._store.iter_chunks(self._chunk(chunk_size)):
            yield start, unflatten_rows_np(self.flat_spec, block)
            start += block.shape[0]

    # ------------------------------------------------------------------
    # the host API of the figure scripts (the reference's train_clients,
    # aggregate and store_clients), through the round body's own pieces
    def train_clients(self, idx):
        """Local updates of the clients ``idx`` from the global row (one
        batch draw for them), after the uplink compressor: their models
        as ``{name: [S, ...]}`` tensors."""
        idx = np.asarray(idx)
        images, labels, _ = self._client_data(idx)
        state = RoundState(params=self.global_vec, client_params=None,
                           opt_state=None, labels=None)
        rows = self.phases().train_rows(
            state, torch.arange(len(idx), device=self.device), images,
            labels, self._batch_indices(len(idx)))
        spec = self.flat_spec
        return {name: rows[:, off:off + size].reshape((len(idx),) + shape)
                for name, off, size, shape in zip(spec.names, spec.offsets,
                                                  spec.sizes, spec.shapes)}

    def aggregate(self, stacked_params, idx) -> None:
        """The server fold of the clients ``idx``'s models (``{name: [S,
        ...]}`` or ``[S, P]`` rows) into the global row, weighted by their
        sample counts: the aggregator's flat fold (eq. (4) by default)."""
        rows = self._rows_of(stacked_params)
        gvec = self.global_vec
        new_gvec, opt_state = self.aggregator.aggregate_flat(
            gvec, rows, self._sizes[self._index(idx)],
            self.aggregator.init_flat_state(gvec))
        gvec.copy_(new_gvec)
        self.aggregator.load_flat_state(opt_state, self.flat_spec)

    def store_clients(self, stacked_params, idx) -> None:
        """Write the clients ``idx``'s models (``{name: [S, ...]}`` or
        ``[S, P]`` rows) into the client store."""
        self._store.scatter(np.asarray(idx), self._rows_of(stacked_params))

    def _rows_of(self, stacked_params) -> torch.Tensor:
        if isinstance(stacked_params, torch.Tensor):
            return stacked_params
        return flatten_stacked(self.flat_spec, stacked_params)

    # ------------------------------------------------------------------
    def initial_round(self) -> None:
        """Round 0: all devices train and fold (the round body's
        ``train_aggregate``), then K-means clustering (Alg. 2), one fit or
        streamed (``cluster``). On the paged store the fleet trains as the
        active plane when N ≤ ``k_max`` (the dense loop's bits), else in
        waves of ``k_max`` (:meth:`_initial_round_waves`); the stats table
        then asks the next divergences to refresh every row."""
        n = self.fed.num_clients
        idx = np.arange(n)
        ph = self.phases()
        if self._store.kind == "dense":
            state, _ = ph.train_aggregate(
                self._host_state(), self._index(idx), None, self._images,
                self._labels, self._sizes, self._batch_indices(n))
            self.aggregator.load_flat_state(state.opt_state, self.flat_spec)
        elif n <= self.k_max:
            self._on_active(idx, lambda state, t, images, labels, sizes: (
                ph.train_aggregate(state, t, None, images, labels, sizes,
                                   self._batch_indices(n))[0], None))
        else:
            self._initial_round_waves(idx)
        c = self.fl.num_clusters
        if self.cluster_mode == "minibatch":
            chunks = lambda: (blk for _, blk in self.iter_client_features())
            _, labels, _ = kmeans_fit_minibatch(chunks, c, draws=self.draws,
                                                device=self.device)
        else:
            _, labels, _ = kmeans_fit(self.client_features(), c,
                                      draws=self.draws)
        self.cluster_labels = labels.cpu().numpy()
        self.clusters = clusters_from_labels(self.cluster_labels, c)
        if self._store.kind == "paged":
            self._finish_paged_round(idx)

    def _on_active(self, idx, run, sched=None):
        """``run(state, local, images, labels, sizes) -> (state, out)`` on
        the active plane of ``idx``: the store's rows gathered to the
        device as the carry's plane, ``local`` = 0..K−1 their indices in
        it, the clients' data gathered beside them (``sched``: the carry's
        stats table, the active clients' entries); the plane's rows
        written back to the store after — under faults only the lanes
        ``out.kept`` marks (a lost or corrupted upload never lands).
        Returns ``(stored ids, their rows, out)``."""
        block = self._store.gather(idx)
        state = RoundState(params=self.global_vec, client_params=block,
                           opt_state=self.aggregator.init_flat_state(
                               self.global_vec),
                           labels=None, sched=sched)
        local = torch.arange(len(idx), device=self.device)
        state, out = run(state, local, *self._client_data(idx))
        self.aggregator.load_flat_state(state.opt_state, self.flat_spec)
        kept = getattr(out, "kept", None)
        if kept is not None:
            sel = np.flatnonzero(to_host([kept])[0] > 0)
            idx, block = idx[sel], block[self._index(sel)]
        if len(idx):
            self._store.scatter(idx, block)
        return idx, block, out

    def _initial_round_waves(self, idx: np.ndarray) -> None:
        """All devices train in waves of ``k_max`` (the device holds one
        ``[k_max, P]`` block at a time), each wave from the same global row
        on its own batch draw, its rows written to the store; the eq.-(4)
        mean streams over the waves (``streaming_weighted_mean``: not the
        bits of one fold, so a single wave takes the active plane
        instead), then goes through the aggregator as one row of weight 1,
        so a stateful server (momentum) sees one eq.-(4) mean."""
        ph = self.phases()
        state = RoundState(params=self.global_vec, client_params=None,
                           opt_state=None, labels=None)

        def waves():
            for s in range(0, len(idx), self.k_max):
                w_idx = idx[s:s + self.k_max]
                images, labels, _ = self._client_data(w_idx)
                rows = ph.train_rows(
                    state, torch.arange(len(w_idx), device=self.device),
                    images, labels, self._batch_indices(len(w_idx)))
                self._store.scatter(w_idx, rows)
                yield rows, self._sizes_host[w_idx]

        mean = streaming_weighted_mean(waves(), self.flat_spec.total)
        gvec = self.global_vec
        new_gvec, opt_state = self.aggregator.aggregate_flat(
            gvec, torch.as_tensor(mean, device=self.device)[None],
            torch.ones(1, device=self.device),
            self.aggregator.init_flat_state(gvec))
        gvec.copy_(new_gvec)
        self.aggregator.load_flat_state(opt_state, self.flat_spec)

    def divergences(self) -> np.ndarray:
        """Per-client ‖w_n − w_g‖ — the §IV-C selection signal: one row
        reduction over the dense plane, or served from the paged store's
        stats table (:meth:`_paged_divergences`)."""
        if self._store.kind == "dense":
            return weight_divergence_flat(self.client_plane,
                                          self.global_vec).cpu().numpy()
        return self._paged_divergences()

    def _paged_divergences(self) -> np.ndarray:
        """The stats table's divergences: every untouched client IS the
        base row, so one ``[1, P]`` reduction gives all of theirs (the same
        bits as a row of a dense sweep); the touched rows keep their last
        refresh, redone in ``chunk_size`` batches every
        ``div_refresh_every`` rounds (1 = every round = the dense signal
        exactly; 0 = only when forced, staleness bounded by
        ``stats.drift``)."""
        store, stats = self._store, self.stats
        gvec = self.global_vec
        base = torch.as_tensor(store.base).to(self.device)[None, :]
        base_d = ops.client_divergence(base, gvec).cpu().numpy()[0]
        untouched = ~store.touched
        stats.divergence[untouched] = base_d
        stats.drift[untouched] = 0.0
        every = self._div_refresh_every
        # a forced refresh covers a mass write that set no divergence (the
        # initial round), so even every = 0 never serves an unset entry
        forced = self._rounds_since_refresh >= FORCE_REFRESH
        if (store.num_touched
                and (forced or (every > 0
                                and self._rounds_since_refresh >= every))):
            tidx = np.flatnonzero(store.touched)
            for s in range(0, len(tidx), self.chunk_size):
                batch = tidx[s:s + self.chunk_size]
                stats.divergence[batch] = ops.client_divergence(
                    store.gather(batch), gvec).cpu().numpy()
            stats.drift[store.touched] = 0.0
            self._rounds_since_refresh = 0
        return stats.divergence.copy()

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
        """Spectrum allocation for the selected devices (the fleet's
        build-time ``inr`` folded in; no cross gains reach a solver)."""
        arr = fleet_arrays(self.fleet.select(np.asarray(idx)), self.device)
        arr.pop("xgain", None)
        return self.allocator.allocate(arr, self.B)

    def allocate(self, idx):
        a = self.allocation(idx)
        return a.T, a.E

    def round(self, method=None) -> RoundResult:
        """One full FL round: select on the host, then the round body's
        ``finish_phase`` (allocate → train → fold → evaluate) eagerly on
        the experiment's state, each phase a span (``fl.select`` …,
        ``repro_torch.utils.spans``: a profiler range, kept with its device
        stamps while a profiler records). ``method`` picks the selector as in :meth:`select`. On the
        paged store the selection keeps only the clients the stats table
        marks available, and the round runs on their active plane
        (:meth:`_paged_round`). A selection that comes back empty (or
        churned out) is an explicit no-op round: nothing trains,
        T_k = E_k = 0."""
        with span("fl.select", self.device):
            idx = self.select(method)
        paged = self._store.kind == "paged"
        if paged:
            idx = idx[self.stats.avail[idx]]
        live = idx
        if self.quarantine_after > 0:
            ok = self.stats.strikes[idx] < float(self.quarantine_after)
            live = idx[ok]
        if live.size == 0:
            acc, per_class = self.evaluate()
            return RoundResult(selected=live, T_k=0.0, E_k=0.0, accuracy=acc,
                               per_class=per_class)
        if self._faults_on and self.faults.chan_outage > 0.0:
            raise ValueError(
                "faults: chan_outage needs the fade state the scanned "
                "program carries; the host round loop has none — run a "
                "traceable bundle with no target_accuracy (store='dense')")
        if paged:
            return self._paged_round(live)
        t = self._index(idx)
        # a quarantined client keeps its lane, masked, as on the
        # device-resident run, so both draw over the same lanes
        mask = (None if live is idx
                else torch.as_tensor(ok).to(self.device))
        arr = fleet_arrays(self.fleet, self.device)
        arr.pop("xgain", None)
        state = self._host_state()
        batch = self._batch_indices(len(t))
        state, out = self.phases().finish_phase(
            state, arr, t, mask, self._images, self._labels, self._sizes,
            batch, self.test_images, self.test_labels,
            fault=self._fault_draw(len(t)))
        self.aggregator.load_flat_state(state.opt_state, self.flat_spec)
        if self._track_faults:
            self._load_counts(state.sched, idx)
        return RoundResult(selected=live, T_k=float(out.T), E_k=float(out.E),
                           accuracy=float(out.accuracy),
                           per_class=out.per_class.cpu().numpy(),
                           band_mhz=float(out.band))

    def _fault_draw(self, lanes: int):
        """A round's fault draw over ``lanes`` dispatched clients (``None``
        without an active fault spec)."""
        if not self._faults_on:
            return None
        return draw_fault_masks(self.faults, (lanes,), self.draws)

    def _load_counts(self, sched, idx, local: bool = False) -> None:
        """The ``faults`` and ``strikes`` a round's carry counted, into the
        stats table (``local``: the carry holds the active clients' ``idx``
        entries only)."""
        faults, strikes = to_host([sched.faults, sched.strikes])
        for col, new in ((self.stats.faults, faults),
                         (self.stats.strikes, strikes)):
            if local:
                col[idx] = new
            else:
                col[:] = new

    def _paged_round(self, idx: np.ndarray) -> RoundResult:
        """The round body's ``finish_phase`` on the active plane of ``idx``
        (fleet arrays of the selection alone, no O(N) upload), then the
        stats table's upkeep — under faults of the rows that landed only
        (none landed: no upkeep, as nothing moved)."""
        arr = fleet_arrays(self.fleet.select(idx), self.device)
        arr.pop("xgain", None)
        ph = self.phases()
        sched = None
        if self._track_faults:
            sched = ClientStats(*(c[idx] if c.ndim else c
                                  for c in self.stats)).device(self.device)

        def run(state, t, images, labels, sizes):
            batch = self._batch_indices(len(t))
            return ph.finish_phase(
                state, arr, t, None, images, labels, sizes, batch,
                self.test_images, self.test_labels,
                fault=self._fault_draw(len(t)), clients=self._index(idx))

        stored, rows, out = self._on_active(idx, run, sched)
        if sched is not None:
            self._load_counts(sched, idx, local=True)
        if out.kept is None or len(stored):
            self._finish_paged_round(stored, rows)
        return RoundResult(selected=idx, T_k=float(out.T), E_k=float(out.E),
                           accuracy=float(out.accuracy),
                           per_class=out.per_class.cpu().numpy(),
                           band_mhz=float(out.band))

    def _finish_paged_round(self, idx: np.ndarray, rows=None) -> None:
        """The stats table after a paged round: every stale entry's drift
        grows by ‖g_new − g_old‖, the round's trained ``rows`` get exact
        divergences (one O(K·P) reduction of rows already on the device),
        ages advance. ``rows = None`` (the initial round's mass write)
        forces the next :meth:`divergences` to refresh."""
        gvec_host = self.global_vec.to("cpu", copy=True).numpy()
        st = self.stats
        delta = float(np.linalg.norm(gvec_host - self._gvec_host))
        st.drift[self._store.touched] += delta
        if rows is not None:
            st.divergence[idx] = ops.client_divergence(
                rows, self.global_vec).cpu().numpy()
            st.drift[idx] = 0.0
        st.age[:] += 1
        st.age[idx] = 0
        self._gvec_host = gvec_host
        if rows is None:
            self._rounds_since_refresh = FORCE_REFRESH
        else:
            self._rounds_since_refresh = min(
                self._rounds_since_refresh + 1, FORCE_REFRESH - 1)

    def _churn_step_host(self) -> None:
        """Round-level Bernoulli churn on the stats table's availability
        mask, from the host Generator ``rng``: a departed client's cold row
        stays as it is and is picked up again on rejoin."""
        p_leave, p_join = self.churn
        n = self.fed.num_clients
        leave = self.rng.random(n) < p_leave
        join = self.rng.random(n) < p_join
        avail = self.stats.avail
        avail[:] = np.where(avail, ~leave, join)

    def run(self, method=None, rounds: Optional[int] = None,
            target_accuracy: Optional[float] = None,
            include_initial_round: bool = True, *,
            checkpoint_every: int = 0,
            checkpoint_dir: Optional[str] = None,
            checkpoint_offset: int = 0,
            checkpoint_spec: Optional[dict] = None,
            history: Optional[FLHistory] = None) -> FLHistory:
        """The initial round (recorded as round 0, all devices; skipped when
        ``include_initial_round`` is False and the clusters exist), then
        ``rounds`` rounds with the selector ``method``.

        Two paths, one result: when :meth:`traceable` holds for the
        bundle, the selector draws nothing (``needs_rng`` False) and no
        ``target_accuracy`` asks for an early stop, the rounds run on the
        device (:meth:`_run_traced`); otherwise the host loop drives
        :meth:`round`, stopping once the test accuracy reaches the target
        (0 = never). A failed capture or launch raises: nothing falls back.
        A single cell of a dynamic-interference fleet raises (its
        interference comes from the other cells' selections: run the spec
        through ``CohortRunner``), as does a fading channel on the host
        loop. A paged store always takes the host loop (the device-resident
        run's carry is the ``[N, P]`` plane it exists to avoid), which
        skips the initial round unless asked for or the selector needs
        clusters, and churns the availability mask before each round.

        An async-capable aggregator (``fedbuff``) runs ticks instead, with
        churn inside each: on the dense store the device-resident run
        (:meth:`_run_traced`; a stochastic selector takes its draws from
        the experiment's draws object, as the asynchronous engine has no
        host loop, and an accuracy target raises), on the paged store
        :meth:`_run_async_paged`, which stops at the target.

        ``checkpoint_every > 0`` snapshots every that many rounds (or
        ticks) into ``checkpoint_dir`` (:meth:`save_checkpoint`, with
        ``checkpoint_spec`` in the manifest), the round numbers counted
        from ``checkpoint_offset``; it drives a host loop, never the
        device-resident run, so the dense asynchronous engine and a
        fading channel refuse it. ``history`` (a resumed run's, from
        :meth:`load_checkpoint`) gets this run's rounds after its own.
        """
        self._refuse_single_cell_view()
        rounds = rounds or self.fl.max_rounds
        target = (self.fl.target_accuracy
                  if target_accuracy is None else target_accuracy)
        ck = None
        if checkpoint_every:
            if not checkpoint_dir:
                raise ValueError(
                    "checkpoint_every > 0 needs a checkpoint_dir")
            ck = _Checkpointer(self, checkpoint_dir, int(checkpoint_every),
                               int(checkpoint_offset), checkpoint_spec)
        selector = (self.selector if method is None
                    else SELECTORS.resolve(method))
        is_async = getattr(self.aggregator, "async_capable", False)
        if is_async and not self.traceable(selector):
            raise ValueError(
                "the buffered-asynchronous engine needs a fully traceable "
                "strategy bundle (selector/allocator/compressor/channel)")
        if self._store.kind == "paged":
            if (getattr(self.channel, "needs_rng", False)
                    or getattr(self.channel, "stateful", False)):
                raise ValueError(
                    f"channel {self.channel.registry_name!r} redraws fading "
                    "inside the device-resident run; store='paged' drives "
                    "the host loop — use the static channel (or "
                    "store='dense')")
            if is_async:
                return self._run_async_paged(selector, rounds, target,
                                             include_initial_round, history,
                                             ck)
            return self._run_host(method, rounds, target,
                                  include_initial_round, history, ck)
        if is_async:
            if target:
                raise ValueError(
                    "the dense buffered-asynchronous engine runs as one "
                    "device-resident program and cannot stop early on "
                    "target_accuracy; use store='paged' (a host-composed "
                    "tick) or no target")
            if ck is not None:
                raise ValueError(
                    "the dense buffered-asynchronous engine runs as ONE "
                    "scanned program with no host boundary to snapshot "
                    "at; checkpoint with store='paged' (the host-composed "
                    "async loop) or checkpoint_every=0")
            out = self._run_traced(selector, rounds, include_initial_round,
                                   draws=self.draws)
            return history.extend(out) if history is not None else out
        if (not target and not getattr(selector, "needs_rng", True)
                and self.traceable(selector) and ck is None):
            out = self._run_traced(selector, rounds, include_initial_round)
            return history.extend(out) if history is not None else out
        return self._run_host(method, rounds, target, include_initial_round,
                              history, ck)

    def _run_host(self, method, rounds: int, target: float,
                  include_initial_round: bool = True,
                  history: Optional[FLHistory] = None,
                  ck: Optional[_Checkpointer] = None) -> FLHistory:
        """The host round loop, each round's wall clock in ``seconds``.
        The initial round runs when asked for or when there are no
        clusters yet — on the paged store only when the selector needs
        them (a million-client fleet under a cluster-free policy never
        trains every client); with churn, the mask steps before each
        round; ``ck`` snapshots when due."""
        self._refuse_single_cell_view()
        if ck is not None and getattr(self.channel, "stateful", False):
            raise ValueError(
                f"channel {self.channel.registry_name!r} carries fade "
                "state only the scanned program steps; checkpointing "
                "drives the host round loop — use the static channel or "
                "checkpoint_every=0")
        if getattr(self.channel, "needs_rng", False):
            raise ValueError(
                f"channel {self.channel.registry_name!r} redraws fading "
                "inside the device-resident run and has no host-loop "
                "equivalent; run it with a traceable strategy bundle and "
                "no target_accuracy (or through CohortRunner)")
        hist = history if history is not None else FLHistory()
        selector = (self.selector if method is None
                    else SELECTORS.resolve(method))
        self._maybe_initial_round(hist, selector, include_initial_round)
        churn_on = self.churn != (0.0, 0.0)
        for k in range(rounds):
            t0 = time.perf_counter()
            if churn_on:
                self._churn_step_host()
            res = self.round(method)
            hist.append(res, time.perf_counter() - t0)
            if ck is not None:
                ck.maybe(k, hist)
            if target and res.accuracy >= target:
                hist.rounds_to_target = k + 1
                break
        return hist

    def _maybe_initial_round(self, hist: FLHistory, selector,
                             include_initial_round: bool) -> None:
        """The initial round, recorded as round 0 of ``hist``, when asked
        for or when there are no clusters yet — on the paged store only
        when the selector needs them (a million-client fleet under a
        cluster-free policy never trains every client)."""
        need_clusters = (self._store.kind == "dense"
                         or getattr(selector, "needs_clusters", False))
        if not (include_initial_round
                or (self.clusters is None and need_clusters)):
            return
        t0 = time.perf_counter()
        self.initial_round()
        acc, per_class = self.evaluate()
        all_idx = np.arange(self.fed.num_clients)
        a = self.allocation(all_idx)
        hist.append(RoundResult(
            selected=all_idx, T_k=float(a.T), E_k=float(a.E),
            accuracy=acc, per_class=per_class,
            band_mhz=float(torch.sum(a.b))), time.perf_counter() - t0)

    def _run_async_paged(self, selector, rounds: int, target: float,
                         include_initial_round: bool = True,
                         history: Optional[FLHistory] = None,
                         ck: Optional[_Checkpointer] = None) -> FLHistory:
        """Buffered-asynchronous ticks over the paged store: the host
        composition of ``async_engine.build_paged_async``'s pieces with
        store paging in between, each tick's wall clock in ``seconds``.

        A tick: (host) the stats table's divergences per the
        ``div_refresh_every`` cadence into the carry → ``sched`` (churn →
        select → in-flight filter) → (host) the cohort's data gathered at
        ``min(idx, N − 1)`` → ``plan`` → ``train`` → (host) ``store.stage``
        of the dispatched rows and ``gather_staged`` of the M candidates →
        ``fire`` → (host) the fired rows released, ‖g_new − g_old‖ into
        the drift bounds, the fired clients' refreshed divergences. The
        device holds O(k_max·P + M·P) at any N; the draws are the dense
        tick's, in its order, so at ``div_refresh_every=1`` the run is the
        dense store's bit for bit. The initial round runs as in
        :meth:`_run_host`; ``target`` stops the run early. Under faults
        only the dispatches ``plan`` marks good are staged, and only the
        candidates the guard folded refresh their divergence; ``ck``
        folds the carry into the experiment and snapshots when due."""
        from repro_torch.core.async_engine import build_paged_async
        prog = build_paged_async(
            self.engine_cfg, self.aggregator, selector, self.allocator,
            self.traced_context(), self.fl.feature_layer, self.base,
            compressor=self.compressor, channel=self.channel,
            churn=self.churn, **self._fault_args())
        hist = history if history is not None else FLHistory()
        self._maybe_initial_round(hist, selector, include_initial_round)
        arr = fleet_arrays(self.fleet, self.device)
        arr.pop("xgain", None)
        store, stats, n = self._store, self.stats, self.fed.num_clients
        kind = selector_draw_kind(selector)
        needs_div = getattr(selector, "needs_divergence", False)
        state = self.traced_state(selector)
        for k in range(rounds):
            t0 = time.perf_counter()
            churn = (torch.stack(self.draws.churn_step(n))
                     if prog.churn_on else None)
            draw = (None if kind is None
                    else self.draws.selector_draw(kind, n))
            fault = self._fault_draw(prog.pad)
            batch = self._batch_indices(prog.pad)
            if needs_div:
                div = torch.as_tensor(self._paged_divergences(),
                                      device=self.device)
                state = state._replace(
                    sched=state.sched._replace(divergence=div))
            state, arr_f, idx, mask = prog.sched(state, arr, draw, churn)
            idx_h, mask_h = to_host([idx, mask])
            idx_h, mask_h = idx_h.astype(np.int64), mask_h > 0
            # padding lanes read client N − 1's data, train, and are
            # dropped by the mask (the dense tick's clamped gather)
            images, labels, _ = self._client_data(np.minimum(idx_h, n - 1))
            (state, T, E, band, cand, fired_cand, w_cand, good,
             traces) = prog.plan(state, arr_f, idx, mask, self._sizes,
                                 fault)
            rows = prog.train(state, images, labels, batch, idx)
            live = idx_h[mask_h]
            # the good lanes only (the mask, fault-free): a lost or
            # corrupted dispatch never reaches the store
            good_h = (mask_h if not prog.faults_on
                      else to_host([good])[0] > 0)
            if good_h.any():
                store.stage(idx_h[good_h],
                            rows[self._index(np.flatnonzero(good_h))])
            cand_h, fired_h = to_host([cand, fired_cand])
            cand_h, fired_h = cand_h.astype(np.int64), fired_h > 0
            cand_rows = store.gather_staged(cand_h)
            state, acc, per_class, div_cand, g_delta, ok_cand = prog.fire(
                state, cand, cand_rows, w_cand, fired_cand,
                self.test_images, self.test_labels)
            fired_ids = cand_h[fired_h]
            store.release_staged(fired_ids)
            (acc, g_delta, T, E, band, part, stale, active, div_cand,
             per_class, ok_h) = to_host([acc, g_delta, T, E, band, *traces,
                                         div_cand, per_class, ok_cand])
            # the stats table after the fold: every stale bound grows by
            # the fold's global step (0 on an empty fire), the candidates
            # folded get their refreshed divergence (a guarded row's entry
            # must not turn NaN)
            ok_h = ok_h > 0
            stats.drift[store.touched] += float(g_delta)
            stats.divergence[cand_h[ok_h]] = div_cand[ok_h]
            stats.drift[cand_h[ok_h]] = 0.0
            # the next refresh measures against the new global row
            self.global_vec.copy_(state.params)
            self._gvec_host = state.params.to("cpu", copy=True).numpy()
            self._rounds_since_refresh = min(
                self._rounds_since_refresh + 1, FORCE_REFRESH - 1)
            hist.append(RoundResult(selected=live, T_k=float(T),
                                    E_k=float(E), accuracy=float(acc),
                                    per_class=per_class.astype(np.float32),
                                    band_mhz=float(band)),
                        time.perf_counter() - t0)
            hist.participation.append(float(part))
            hist.staleness.append(float(stale))
            hist.active.append(float(active))
            if ck is not None and ck.due(k):
                # the carry into the experiment (read-only on it), the
                # snapshot, then the same carry drives on
                self._fold_async_carry(state)
                ck.save(k, hist)
            if target and float(acc) >= target:
                hist.rounds_to_target = k + 1
                break
        self._fold_async_carry(state)
        return hist

    def _fold_async_carry(self, state: RoundState) -> None:
        """An asynchronous carry back into the experiment: the global row,
        the server state and the scheduler's columns of the stats table
        (its divergence and drift the host keeps up itself)."""
        self.global_vec.copy_(state.params)
        self.aggregator.load_flat_state(state.opt_state, self.flat_spec)
        for col in ("age", "t_done", "avail", "t_now", "faults", "strikes"):
            np.copyto(getattr(self.stats, col),
                      getattr(state.sched, col).cpu().numpy())

    # ------------------------------------------------------------------
    # checkpoint / resume (repro_torch.train.checkpoint)
    def save_checkpoint(self, directory: str, round_idx: int,
                        history: Optional[FLHistory] = None,
                        spec_dict: Optional[dict] = None,
                        keep_last: int = 3) -> str:
        """An atomic snapshot of the whole experiment in
        ``directory/round_%06d/``: the global row, the draws' generator
        state (a ``uint8`` leaf), the aggregator's flat state, the K-means
        labels and the stats table (``leaves.npz`` + ``manifest.json``),
        and the client store as ``store_*.npz`` blocks of ``chunk_size``
        rows (a paged store writes its touched rows only). The numpy
        Generator's state, the history and the spec ride in the manifest.
        The snapshot is written under a temporary name, ``os.replace``d
        into place, then ``LATEST`` flips; the ``keep_last`` newest
        snapshots stay. Returns the snapshot's path."""
        from repro_torch.train import checkpoint as ckpt
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, "round_%06d" % int(round_idx))
        tmp = final + ".tmp"
        for stale in (tmp, final):
            if os.path.isdir(stale):
                shutil.rmtree(stale)
        opt = self.aggregator.init_flat_state(self.global_vec)
        tree = {"gvec": self.global_vec,
                "opt": np.zeros((0,), np.float32) if opt is None else opt,
                "labels": self._labels_tensor(),
                "draws": self.draws.state(),
                "stats": dict(self.stats._asdict())}
        extra = {
            "round": int(round_idx),
            "store_kind": self._store.kind,
            "opt_none": opt is None,
            "has_clusters": self.cluster_labels is not None,
            "rounds_since_refresh": int(self._rounds_since_refresh),
            "rng_state": self.rng.bit_generator.state,
            "spec": spec_dict,
            "history": None if history is None else history.to_dict(),
        }
        ckpt.save_checkpoint(tmp, tree, step=int(round_idx), extra=extra)
        self._save_store_rows(tmp)
        os.replace(tmp, final)
        ckpt.write_latest(directory, os.path.basename(final))
        if keep_last:
            snaps = sorted(d for d in os.listdir(directory)
                           if d.startswith("round_")
                           and not d.endswith(".tmp"))
            for name in snaps[:-keep_last]:
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)
        return final

    def _snapshot_template(self, opt_none: bool) -> dict:
        """A snapshot's leaves, shaped and typed as :meth:`load_checkpoint`
        restores them."""
        return {"gvec": self.global_vec,
                "opt": (np.zeros((0,), np.float32) if opt_none
                        else torch.zeros_like(self.global_vec)),
                "labels": torch.zeros((self.fed.num_clients,),
                                      dtype=torch.long),
                "draws": self.draws.state(),
                "stats": dict(self.stats._asdict())}

    def _save_store_rows(self, path: str) -> None:
        """The client store as ``store_*.npz`` blocks of ``{idx, rows}``,
        ``chunk_size`` rows at a time."""
        store = self._store
        if store.kind == "paged":
            tidx = np.flatnonzero(store.touched)
            for ci, s in enumerate(range(0, tidx.size, self.chunk_size)):
                b = tidx[s:s + self.chunk_size]
                np.savez(os.path.join(path, "store_%05d.npz" % ci),
                         idx=b, rows=store.gather(b).cpu().numpy())
            return
        start = 0
        for ci, block in enumerate(store.iter_chunks(self.chunk_size)):
            c = block.shape[0]
            np.savez(os.path.join(path, "store_%05d.npz" % ci),
                     idx=np.arange(start, start + c), rows=block)
            start += c

    def load_checkpoint(self, directory: str,
                        expected_spec: Optional[dict] = None):
        """Restore a :meth:`save_checkpoint` snapshot into this freshly
        built experiment (the same spec: ``expected_spec`` is checked
        against the one the manifest recorded). ``directory`` is the
        snapshot or a parent of ``round_*`` snapshots with ``LATEST``.
        Returns ``(round_idx, history)``: hand them to :meth:`run` as
        ``checkpoint_offset`` and ``history`` with
        ``include_initial_round=False``, and the run goes on as the
        uninterrupted one, bit for bit."""
        from repro_torch.train import checkpoint as ckpt
        path = ckpt.latest_checkpoint(directory)
        extra = ckpt.checkpoint_extra(path)
        if extra.get("store_kind") != self._store.kind:
            raise ValueError(
                f"checkpoint was taken on store={extra.get('store_kind')!r}"
                f" but this experiment runs store={self._store.kind!r}")
        if (expected_spec is not None and extra.get("spec") is not None
                and extra["spec"] != expected_spec):
            diff = sorted(k for k in set(extra["spec"]) | set(expected_spec)
                          if extra["spec"].get(k) != expected_spec.get(k))
            raise ValueError(
                "checkpoint spec does not match this experiment's spec "
                f"(differing fields: {diff}); resume rebuilds from the "
                "checkpoint's own spec")
        tree = ckpt.load_checkpoint(path, self._snapshot_template(
            extra["opt_none"]))
        self.global_vec.copy_(tree["gvec"])
        self.draws.load_state(tree["draws"])
        if extra["has_clusters"]:
            self.cluster_labels = tree["labels"].numpy()
            self.clusters = clusters_from_labels(self.cluster_labels,
                                                 self.fl.num_clusters)
        else:
            self.cluster_labels = self.clusters = None
        self.aggregator.reset()
        if not extra["opt_none"]:
            self.aggregator.load_flat_state(tree["opt"], self.flat_spec)
        for name, arr in tree["stats"].items():
            np.copyto(getattr(self.stats, name), arr)
        self.rng.bit_generator.state = extra["rng_state"]
        self._rounds_since_refresh = int(extra["rounds_since_refresh"])
        for fn in sorted(glob.glob(os.path.join(path, "store_*.npz"))):
            with np.load(fn) as data:
                idx, rows = data["idx"], data["rows"]
            if idx.size:
                self._store.scatter(idx, torch.as_tensor(rows))
        if self._store.kind == "paged":
            self._gvec_host = self.global_vec.to("cpu", copy=True).numpy()
        hist = (None if extra.get("history") is None
                else FLHistory.from_dict(extra["history"]))
        return int(extra["round"]), hist

    def _refuse_single_cell_view(self) -> None:
        if (getattr(self.channel, "dynamic", False)
                and self.fleet.num_cells > 1):
            raise ValueError(
                f"channel {self.channel.registry_name!r} computes per-round "
                "interference from the OTHER cells' selections; a single-"
                "cell FLExperiment cannot see them — run the multi-cell "
                "spec through CohortRunner (build_cohort)")

    # ------------------------------------------------------------------
    # the device-resident run
    def traceable(self, selector=None) -> bool:
        """True when the strategy bundle implements the traced contracts
        (``traceable = True``, the aggregator's flat-state methods and the
        compressor's ``apply_flat``)."""
        selector = self.selector if selector is None else selector
        return (all(getattr(s, "traceable", False)
                    for s in (selector, self.allocator, self.aggregator,
                              self.compressor, self.channel))
                and all(hasattr(self.aggregator, m)
                        for m in ("aggregate_flat", "init_flat_state",
                                  "load_flat_state"))
                and hasattr(self.compressor, "apply_flat"))

    def traced_context(self) -> TracedContext:
        return TracedContext(num_devices=self.fed.num_clients,
                             devices_per_round=self.fl.devices_per_round,
                             selected_per_cluster=self.fl.selected_per_cluster,
                             num_clusters=self.fl.num_clusters,
                             bandwidth_mhz=self.B)

    def traced_state(self, selector=None) -> RoundState:
        """The experiment's mutable state as a fresh carry: the global row,
        the client plane with ``selector.pad_size`` rows after it for the
        padding lanes' writes (none on the paged store, whose ticks carry
        no plane), the aggregator's state, the K-means labels (zeros
        before the initial round) and, for an async-capable aggregator or
        under faults or quarantine, a device copy of the stats table
        (``sched``: a second run continues its virtual clock and its
        counts)."""
        selector = self.selector if selector is None else selector
        n = self.fed.num_clients
        plane = None
        if self._store.kind == "dense":
            pad = selector.pad_size(self.traced_context())
            buf = self._store.buffer
            if isinstance(buf, ColumnBlocks):
                plane = buf.padded(pad)
            else:
                plane = torch.zeros((n + pad, buf.shape[1]), dtype=buf.dtype,
                                    device=self.device)
                plane[:n] = buf
        gvec = self.global_vec.clone()
        sched = (self.stats.device(self.device)
                 if (getattr(self.aggregator, "async_capable", False)
                     or self._track_faults)
                 else None)
        return RoundState(params=gvec, client_params=plane,
                          opt_state=self.aggregator.init_flat_state(gvec),
                          labels=self._labels_tensor(), sched=sched)

    def traced_inputs(self) -> RoundInputs:
        """What the device-resident run reads besides the carry: the
        clients' data, the fleet's arrays (with a dynamic fleet's cross
        gains ``xgain``) and the test set."""
        return RoundInputs(images=self._images, labels=self._labels,
                           sizes=self._sizes,
                           arr=fleet_arrays(self.fleet, self.device),
                           test_images=self.test_images,
                           test_labels=self.test_labels)

    def load_traced_state(self, state: RoundState, *,
                          labels: Optional[np.ndarray] = None) -> None:
        """Copy a finished carry back into the experiment (the padding rows
        sliced off), so the host loop or another run continues from it.
        ``labels``: the carry's K-means labels already on the host. An
        asynchronous carry's stats table is copied into the store's."""
        n = self.fed.num_clients
        self.global_vec = state.params.clone()
        plane = state.client_params
        self.client_plane = (plane.head(n) if isinstance(plane, ColumnBlocks)
                             else plane[:n].clone())
        self.aggregator.load_flat_state(state.opt_state, self.flat_spec)
        if state.sched is not None:
            self.stats.load(state.sched)
        self.cluster_labels = (state.labels.cpu().numpy() if labels is None
                               else np.asarray(labels, dtype=np.int64))
        self.clusters = clusters_from_labels(self.cluster_labels,
                                             self.fl.num_clusters)

    def traced_run(self, selector, rounds: int,
                   include_initial_round: bool = True,
                   draws=None) -> TracedRunResult:
        """The device-resident run, its result still on the device (the
        experiment's own state is not updated: :meth:`_run_traced` does
        that). ``draws`` replaces the experiment's draws object for the
        run. A stochastic selector runs here only when the caller supplies
        ``draws`` (it then draws each round's selection from them, not
        from the host Generator ``rng`` of the host loop); without, it
        raises naming the port, and :meth:`run` takes the host loop."""
        if getattr(selector, "needs_rng", True) and draws is None:
            raise NotImplementedError(
                f"the traced run of the stochastic selector "
                f"{getattr(selector, 'registry_name', selector)!r} without "
                "draws: not in the PyTorch port (repro_torch); pass draws= "
                "(FLExperiment.run() takes the host loop for it)")
        with_init = include_initial_round or self.clusters is None
        inputs = self.traced_inputs()
        blocks = (tuple(self.plane_mesh.devices.flat)
                  if self.plane_split > 1 else None)
        prog = run_rounds(
            self.engine_cfg, selector=selector, allocator=self.allocator,
            aggregator=self.aggregator, tctx=self.traced_context(),
            feature_layer=self.fl.feature_layer, device=self.device,
            shapes=inputs.shapes(), base=self.base,
            compressor=self.compressor, channel=self.channel,
            churn=self.churn, plane_devices=blocks, **self._fault_args())
        self.program = prog
        state = self.traced_state(selector)
        if self.plane_mesh is not None:
            state = self._place_carry(state)
        return prog(state, *inputs,
                    draws=self.draws if draws is None else draws,
                    rounds=rounds, with_init=with_init)

    def _place_carry(self, state: RoundState) -> RoundState:
        """The carry on the plane's mesh: the plane by its ``plane_spec``
        (the reference's: its column axis over ``model``) where
        ``plane_split > 1``, else whole on the lead position; every other
        leaf whole on the lead, the ``[P]`` row and the server state
        included, which training, the compressor, the fold and
        evaluation read whole."""
        mesh, plane = self.plane_mesh, state.client_params
        rest = state._replace(client_params=None)
        rest = sh.device_put(rest, sh.lead_shardings(rest, mesh))
        shards = (sh.plane_shardings(plane, mesh, self.flat_spec.total)
                  if self.plane_split > 1 else sh.lead_shardings(plane, mesh))
        return rest._replace(client_params=sh.device_put(plane, shards))

    def _run_traced(self, selector, rounds: int,
                    include_initial_round: bool = True,
                    draws=None) -> FLHistory:
        """:meth:`traced_run`, then its history and the carry's labels in
        one device-to-host transfer, and the carry back into the
        experiment."""
        res = self.traced_run(selector, rounds, include_initial_round,
                              draws=draws)
        *vals, labels = to_host(history_parts(res) + [res.state.labels])
        self.load_traced_state(res.state, labels=labels)
        return self.history_from_traced(res, self.fed.num_clients, vals)

    @staticmethod
    def history_from_traced(res: TracedRunResult, num_devices: int,
                            values=None) -> FLHistory:
        """A traced run's history: accuracy, T_k, E_k, Σ b_n, per-class
        accuracy and the selections (padding lanes stripped), and an
        asynchronous run's traces, read in one transfer (``values``:
        :func:`history_parts` already on the host). ``seconds`` stays
        empty: the rounds have no host boundary of their own to time. (A
        cohort's lanes: ``CohortHistory.history``.)"""
        vals = list(to_host(history_parts(res)) if values is None
                    else values)
        hist = FLHistory()
        if res.init is not None:
            acc, T, E, band, per_class = vals[:5]
            del vals[:5]
            hist.append(RoundResult(
                selected=np.arange(num_devices), T_k=float(T), E_k=float(E),
                accuracy=float(acc), per_class=per_class.astype(np.float32),
                band_mhz=float(band)))
        if res.rounds is not None:
            r = rounds_by_name(res.rounds, vals)
            for k in range(r["accuracy"].shape[0]):
                hist.append(RoundResult(
                    selected=r["selected"][k][r["mask"][k] > 0].astype(
                        np.int64),
                    T_k=float(r["T"][k]), E_k=float(r["E"][k]),
                    accuracy=float(r["accuracy"][k]),
                    per_class=r["per_class"][k].astype(np.float32),
                    band_mhz=float(r["band"][k])))
            for name in ("participation", "staleness", "active"):
                if name in r:
                    getattr(hist, name).extend(float(x) for x in r[name])
        return hist


def history_parts(res: TracedRunResult) -> list:
    """The tensors of a traced run's history, in :class:`InitOutputs` then
    :class:`RoundOutputs` order (a slot a run leaves ``None`` left out)."""
    return [t for t in (([] if res.init is None else list(res.init))
                        + ([] if res.rounds is None else list(res.rounds)))
            if t is not None]


def rounds_by_name(rounds: RoundOutputs, values) -> dict:
    """The host arrays ``values`` of ``rounds``' slots that are not
    ``None`` (in :class:`RoundOutputs` order, as :func:`history_parts`
    lists them after the initial round's), keyed by slot name."""
    names = [n for n, t in zip(RoundOutputs._fields, rounds) if t is not None]
    return dict(zip(names, values))


def to_host(tensors) -> list:
    """``tensors`` as numpy arrays (float64: exact for every fp32, bool and
    index value here) through ONE device-to-host copy."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(host[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out
