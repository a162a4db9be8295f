"""Federated-learning loop — paper Algorithm 1 + the Fig. 2 framework, over
the dense ``[N, P]`` client plane, by one of two paths that give the same
results:

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

``FLExperiment`` owns the experiment's state on one device — the global
row, the client plane, the data, the K-means labels — one draws object
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
from repro_torch.api.protocols import (Allocation, RoundState,
                                       SelectionContext, TracedContext)
from repro_torch.api.registry import (AGGREGATORS, ALLOCATORS, CHANNELS,
                                      COMPRESSORS, SELECTORS)
from repro_torch.configs.base import FLConfig
from repro_torch.core.clustering import (clusters_from_labels,
                                         extract_features_flat)
from repro_torch.core.divergence import weight_divergence_flat
from repro_torch.core.draws import TorchDraws
from repro_torch.core.engine import (EngineConfig, RoundInputs,
                                     TracedRunResult, build_round_phases,
                                     model_flat_spec, run_rounds)
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
    # host wall clock per round; empty after a device-resident run, whose
    # rounds have no host boundary of their own to time
    seconds: List[float] = field(default_factory=list)
    per_class: List[np.ndarray] = field(default_factory=list)

    def append(self, res: RoundResult, seconds: Optional[float] = None):
        self.accuracy.append(float(res.accuracy))
        self.per_class.append(np.asarray(res.per_class))
        self.T_k.append(float(res.T_k))
        self.E_k.append(float(res.E_k))
        self.selected.append(np.asarray(res.selected))
        self.band_mhz.append(float(res.band_mhz))
        if seconds is not None:
            self.seconds.append(seconds)


def fp32_matmuls() -> None:
    """Keep float32 products in full float32: PyTorch's cuDNN default runs
    fp32 convolutions in TF32 (about three decimal digits), which the
    reference never does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class FLExperiment:
    """The synchronous dense FL loop on one device, driven from the host.

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
    """

    def __init__(self, model_cfg, fed: FederatedData, test_images: np.ndarray,
                 test_labels: np.ndarray, fleet: Fleet, fl: FLConfig, *,
                 device, bandwidth_mhz: float = 20.0, seed: int = 0,
                 batch_size: int = 32, selection=None, allocator="sao",
                 aggregator=None, compression="none", channel="static",
                 server_momentum: float = 0.0, box_correct: bool = False,
                 fedprox_mu: float = 0.0, draws=None):
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
        self.draws = draws if draws is not None else TorchDraws(seed,
                                                                self.device)
        mdef = model_def_for(model_cfg)
        self.base = (self.draws.base_params(model_cfg)
                     if mdef.base is not None else None)
        self.engine_cfg = EngineConfig(model_cfg, fl.learning_rate,
                                       fl.local_iters, batch_size, fedprox_mu)
        self.flat_spec = spec = model_flat_spec(model_cfg)
        self._ph = None
        self.batch_size = batch_size

        params = self.draws.init_params(model_cfg)
        self.global_vec = flatten_vector(spec, params).to(self.device)
        self.client_plane = self.global_vec.repeat(fed.num_clients, 1)
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
        self._images = put(fed.images)
        self._labels = put(fed.labels)
        self._sizes = put(fed.sizes)
        self.clusters: Optional[List[np.ndarray]] = None
        self.cluster_labels: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx), dtype=torch.long,
                               device=self.device)

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
                compressor=self.compressor, channel=self.channel)
        return ph

    def _host_state(self) -> RoundState:
        """The experiment's own state as the round body's carry: the
        global row and the plane themselves (updated in place), the
        aggregator's state and the K-means labels."""
        return RoundState(params=self.global_vec,
                          client_params=self.client_plane,
                          opt_state=self.aggregator.init_flat_state(
                              self.global_vec),
                          labels=self._labels_tensor())

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
        return self.draws.batch_indices(n, self.fl.local_iters,
                                        self.batch_size,
                                        self._images.shape[1])

    def client_features(self, layer: Optional[str] = None) -> torch.Tensor:
        """K-means feature matrix ``[N, F]`` (Alg. 2's input): a column
        view of the plane."""
        layer = self.fl.feature_layer if layer is None else layer
        return extract_features_flat(self.client_plane, layer,
                                     self.flat_spec)

    # ------------------------------------------------------------------
    def initial_round(self) -> None:
        """Round 0: all devices train; then K-means clustering (Alg. 2) —
        the round body's ``cluster_round`` on the experiment's state."""
        state = self.phases().cluster_round(
            self._host_state(), self._images, self._labels, self._sizes,
            self._batch_indices(self.fed.num_clients), self.draws)
        self.aggregator.load_flat_state(state.opt_state, self.flat_spec)
        self.cluster_labels = state.labels.cpu().numpy()
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
        the experiment's state, each phase a profiler span (``fl.select``
        …). ``method`` picks the selector as in :meth:`select`. A
        selection that comes back empty is an explicit no-op round:
        nothing trains, T_k = E_k = 0."""
        with record_function("fl.select"):
            idx = self.select(method)
        if idx.size == 0:
            acc, per_class = self.evaluate()
            return RoundResult(selected=idx, T_k=0.0, E_k=0.0, accuracy=acc,
                               per_class=per_class)
        t = self._index(idx)
        arr = fleet_arrays(self.fleet, self.device)
        arr.pop("xgain", None)
        state, out = self.phases().finish_phase(
            self._host_state(), arr, t, None, self._images, self._labels,
            self._sizes, self._batch_indices(len(t)), self.test_images,
            self.test_labels)
        self.aggregator.load_flat_state(state.opt_state, self.flat_spec)
        return RoundResult(selected=idx, T_k=float(out.T), E_k=float(out.E),
                           accuracy=float(out.accuracy),
                           per_class=out.per_class.cpu().numpy(),
                           band_mhz=float(out.band))

    def run(self, method=None, rounds: Optional[int] = None,
            target_accuracy: Optional[float] = None,
            include_initial_round: bool = True) -> FLHistory:
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
        loop.
        """
        self._refuse_single_cell_view()
        rounds = rounds or self.fl.max_rounds
        target = (self.fl.target_accuracy
                  if target_accuracy is None else target_accuracy)
        selector = (self.selector if method is None
                    else SELECTORS.resolve(method))
        if (not target and not getattr(selector, "needs_rng", True)
                and self.traceable(selector)):
            return self._run_traced(selector, rounds, include_initial_round)
        return self._run_host(method, rounds, target, include_initial_round)

    def _run_host(self, method, rounds: int, target: float,
                  include_initial_round: bool = True) -> FLHistory:
        """The host round loop, each round's wall clock in ``seconds``."""
        self._refuse_single_cell_view()
        if getattr(self.channel, "needs_rng", False):
            raise ValueError(
                f"channel {self.channel.registry_name!r} redraws fading "
                "inside the device-resident run and has no host-loop "
                "equivalent; run it with a traceable strategy bundle and "
                "no target_accuracy (or through CohortRunner)")
        hist = FLHistory()
        if include_initial_round or self.clusters is None:
            t0 = time.perf_counter()
            self.initial_round()
            acc, per_class = self.evaluate()
            all_idx = np.arange(self.fed.num_clients)
            a = self.allocation(all_idx)
            hist.append(RoundResult(
                selected=all_idx, T_k=float(a.T), E_k=float(a.E),
                accuracy=acc, per_class=per_class,
                band_mhz=float(torch.sum(a.b))), time.perf_counter() - t0)
        for k in range(rounds):
            t0 = time.perf_counter()
            res = self.round(method)
            hist.append(res, time.perf_counter() - t0)
            if target and res.accuracy >= target:
                hist.rounds_to_target = k + 1
                break
        return hist

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
        padding lanes' writes, the aggregator's state and the K-means
        labels (zeros before the initial round)."""
        selector = self.selector if selector is None else selector
        n = self.fed.num_clients
        pad = selector.pad_size(self.traced_context())
        plane = torch.zeros((n + pad, self.client_plane.shape[1]),
                            dtype=self.client_plane.dtype, device=self.device)
        plane[:n] = self.client_plane
        gvec = self.global_vec.clone()
        return RoundState(params=gvec, client_params=plane,
                          opt_state=self.aggregator.init_flat_state(gvec),
                          labels=self._labels_tensor())

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
        ``labels``: the carry's K-means labels already on the host."""
        n = self.fed.num_clients
        self.global_vec = state.params.clone()
        self.client_plane = state.client_params[:n].clone()
        self.aggregator.load_flat_state(state.opt_state, self.flat_spec)
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
        prog = run_rounds(
            self.engine_cfg, selector=selector, allocator=self.allocator,
            aggregator=self.aggregator, tctx=self.traced_context(),
            feature_layer=self.fl.feature_layer, device=self.device,
            shapes=inputs.shapes(), base=self.base,
            compressor=self.compressor, channel=self.channel)
        return prog(self.traced_state(selector), *inputs,
                    draws=self.draws if draws is None else draws,
                    rounds=rounds, with_init=with_init)

    def _run_traced(self, selector, rounds: int,
                    include_initial_round: bool = True) -> FLHistory:
        """:meth:`traced_run`, then its history and the carry's labels in
        one device-to-host transfer, and the carry back into the
        experiment."""
        res = self.traced_run(selector, rounds, include_initial_round)
        *vals, labels = to_host(history_parts(res) + [res.state.labels])
        self.load_traced_state(res.state, labels=labels)
        return self.history_from_traced(res, self.fed.num_clients, vals)

    @staticmethod
    def history_from_traced(res: TracedRunResult, num_devices: int,
                            values=None) -> FLHistory:
        """A traced run's history: accuracy, T_k, E_k, Σ b_n, per-class
        accuracy and the selections (padding lanes stripped), read in one
        transfer (``values``: :func:`history_parts` already on the host).
        ``seconds`` stays empty: the rounds have no host boundary of their
        own to time. (A cohort's lanes: ``CohortHistory.history``.)"""
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
            acc, T, E, sel, mask, band, per_class = vals[:7]
            for k in range(acc.shape[0]):
                hist.append(RoundResult(
                    selected=sel[k][mask[k] > 0].astype(np.int64),
                    T_k=float(T[k]), E_k=float(E[k]),
                    accuracy=float(acc[k]),
                    per_class=per_class[k].astype(np.float32),
                    band_mhz=float(band[k])))
        return hist


def history_parts(res: TracedRunResult) -> list:
    """The tensors of a traced run's history, in :class:`InitOutputs` then
    :class:`RoundOutputs` order (a slot a run leaves ``None`` left out)."""
    return [t for t in (([] if res.init is None else list(res.init))
                        + ([] if res.rounds is None else list(res.rounds)))
            if t is not None]


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
