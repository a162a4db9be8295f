"""The round compute of the FL loop, split out of the experiment
(``repro_torch.core.fedavg.FLExperiment``), which owns all state.

Model weights travel on the FLAT PARAMETER PLANE: the global model is one
``[P]`` row and the clients' models are ``[S, P]`` rows (layout =
:func:`model_flat_spec`). Local SGD runs all ``S`` selected clients at
once on stacked ``[S, ...]`` parameters, where the reference ``vmap``s one
client's update; the eq.-(4) fold is the aggregator's, one
``ops.flat_aggregate`` row reduction (the hand-written CUDA kernel on the
card). For the LoRA LM the plane holds adapter rows and the frozen base
rides beside it (``base``).

One round body, :func:`build_round_phases` — divergence → select →
allocate → train → fold → evaluate over a carry (:class:`RoundState`) it
updates in place — serves both ways to run rounds:

* the host loop (``FLExperiment.round``) selects on the host and calls
  the body's ``finish_phase`` eagerly on the experiment's own state;
* :func:`run_rounds` — the device-resident run (the reference's
  ``lax.scan`` program): on the card the whole round is captured once as
  a CUDA graph and replayed once a round, with every round's batch
  indices drawn before the first replay, so nothing reads back to the
  host until the history comes back in one transfer
  (``FLExperiment.history_from_traced``). On the CPU the same body runs
  eagerly.
"""
from __future__ import annotations

import functools
import time
from collections import OrderedDict
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch.api.protocols import RoundState, TracedContext
from repro_torch.core.clustering import extract_features_flat, kmeans_fit
from repro_torch.core.divergence import weight_divergence_flat
from repro_torch.core.graphs import eager_solves
from repro_torch.core.wireless import masked_sum
from repro_torch.models.registry import model_def_for
from repro_torch.utils.trees import (StackFlattenSpec, flatten_stacked,
                                     stack_flatten_spec, unflatten_vector)


@functools.lru_cache(maxsize=64)
def model_flat_spec(model_cfg) -> StackFlattenSpec:
    """The flat-plane layout of one client model of ``model_cfg``, from
    shapes only (meta tensors: nothing is allocated)."""
    shapes = model_def_for(model_cfg).shapes(model_cfg)
    return stack_flatten_spec({name: torch.empty(shape, device="meta")
                               for name, shape in shapes.items()})


@dataclass(frozen=True)
class EngineConfig:
    """The static hyper-parameters of the round compute; with the strategy
    bundle and the shapes it keys a captured round."""
    model_cfg: Any
    learning_rate: float
    local_iters: int
    batch_size: int
    fedprox_mu: float = 0.0


def make_local_update(model_cfg, lr: float, local_iters: int,
                      batch_size: int, base=None, penalty=None):
    """Local training of S clients at once: L SGD steps each on its own
    shard (Alg. 1 lines 6-10), all starting from the same global model.

    The returned ``local_update(params, images, labels, batch_idx)`` takes
    the global ``{name: tensor}``, the clients' shards ``images [S, D, ...]``
    (CNN images, or LM token windows) / ``labels [S, D]`` and the sample
    indices ``batch_idx [S, L, batch]`` (the experiment's draws), and
    returns ``{name: [S, ...]}``. Each step differentiates Σ_s (client s's
    mean loss): client s's parameters appear only in its own term, so its
    slice of the gradient is its own gradient. ``base`` is the workload's
    frozen weights, handed to its loss (``None`` for the paper CNN).
    ``penalty(stacked, params) -> [S]`` adds a term to each client's loss
    (FedProx's proximal term, ``repro_torch.core.algorithms``).
    """
    loss_fn = model_def_for(model_cfg).loss
    if base is not None:
        loss_fn = functools.partial(loss_fn, base=base)

    def local_update(params: Dict[str, torch.Tensor], images, labels,
                     batch_idx) -> Dict[str, torch.Tensor]:
        s = images.shape[0]
        if tuple(batch_idx.shape) != (s, local_iters, batch_size):
            raise ValueError(f"batch_idx is {tuple(batch_idx.shape)}; want "
                             f"[S, L, batch] = {(s, local_iters, batch_size)}")
        lanes = torch.arange(s, device=images.device)[:, None]
        stacked = {k: v.detach().expand((s,) + tuple(v.shape)).clone()
                   for k, v in params.items()}
        for step in range(local_iters):
            idx = batch_idx[:, step]                          # [S, batch]
            leaves = {k: v.requires_grad_(True) for k, v in stacked.items()}
            with torch.enable_grad():
                loss = loss_fn(leaves, images[lanes, idx],
                               labels[lanes, idx], model_cfg)
                if penalty is not None:
                    loss = loss + penalty(leaves, params)
                grads = torch.autograd.grad(loss.sum(),
                                            tuple(leaves.values()))
            with torch.no_grad():
                stacked = {k: w - lr * g
                           for (k, w), g in zip(leaves.items(), grads)}
        return stacked

    return local_update


def local_update_for(cfg: EngineConfig, base=None):
    """``cfg``'s local update: plain SGD, or FedProx when
    ``cfg.fedprox_mu > 0``."""
    if cfg.fedprox_mu > 0:
        from repro_torch.core.algorithms import make_fedprox_local_update
        return make_fedprox_local_update(cfg.model_cfg, cfg.learning_rate,
                                         cfg.local_iters, cfg.batch_size,
                                         mu=cfg.fedprox_mu, base=base)
    return make_local_update(cfg.model_cfg, cfg.learning_rate,
                             cfg.local_iters, cfg.batch_size, base)


def model_evaluate(model_cfg, base=None):
    """``(params, test_x, test_y) -> (accuracy, per_class)`` tensors."""
    frozen = {} if base is None else {"base": base}
    return functools.partial(model_def_for(model_cfg).evaluate,
                             cfg=model_cfg, **frozen)


# ---------------------------------------------------------------------------
# the device-resident run: one round body, replayed
# ---------------------------------------------------------------------------


class RoundOutputs(NamedTuple):
    """What a round leaves in the history: ``[R]`` / ``[R, S_pad]`` /
    ``[R, classes]`` once stacked. ``band`` is Σ b_n of the allocation."""
    accuracy: Any
    T: Any
    E: Any
    selected: Any
    mask: Any
    band: Any
    per_class: Any


class InitOutputs(NamedTuple):
    """The initial (all-device) round's bookkeeping."""
    accuracy: Any
    T: Any
    E: Any
    band: Any
    per_class: Any


class TracedRunResult(NamedTuple):
    """Everything one traced run returns, still on the device. ``state``
    is the program's carry: copy out what outlives the next run."""
    state: RoundState
    rounds: Optional[RoundOutputs]       # None for rounds = 0
    init: Optional[InitOutputs] = None   # None without the initial round


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what}: not in the PyTorch port (repro_torch) yet; the port's "
        "device-resident run takes the deterministic selectors")


def build_round_phases(cfg: EngineConfig, aggregator, selector, allocator,
                       tctx: TracedContext, feature_layer: str, base=None):
    """The closures a round is made of (the single-cell, full-plane subset
    of the reference's ``build_round_phases``), over a
    :class:`RoundState` they update in place:

    ``train_rows`` (local SGD of an index set), ``fold`` (store the rows
    into the plane + the eq.-(4) masked fold), ``train_aggregate`` (the
    two), ``cluster_round`` (Alg. 1 line 1 + Alg. 2: all devices train and
    fold, K-means), ``init_round`` (``cluster_round``, then evaluate and
    allocate over all N), ``select_phase`` (divergence → select),
    ``finish_phase`` (allocate → train → fold → evaluate) and
    ``evaluate_row``. ``mask = None`` marks a selection with no padding
    (the host loop's, and the all-device round's).

    Padding lanes hold the sentinel N: data is gathered at ``min(idx,
    N − 1)`` (JAX clamps a gather), their weight is 0, and lane j's row is
    written to plane row ``N + j``, which nothing reads (JAX drops an
    out-of-bounds scatter). Every index of the write is then distinct, so
    its result does not depend on the order of the writes.
    """
    local_update = local_update_for(cfg, base)
    spec = model_flat_spec(cfg.model_cfg)
    evaluate = model_evaluate(cfg.model_cfg, base)
    N, B = tctx.num_devices, tctx.bandwidth_mhz

    def clamp(idx):
        return torch.clamp(idx, max=N - 1)

    def evaluate_row(gvec, test_images, test_labels):
        """``(accuracy, per_class)`` tensors of the global row ``gvec``."""
        return evaluate(unflatten_vector(spec, gvec), test_images,
                        test_labels)

    def train_rows(state, idx, images, labels, batch_idx):
        t = clamp(idx)
        params = unflatten_vector(spec, state.params)
        stacked = local_update(params, images[t], labels[t], batch_idx)
        return flatten_stacked(spec, stacked)                 # [S_pad, P]

    def fold(state, idx, mask, rows, sizes):
        w = sizes[clamp(idx)]
        store = idx
        if mask is not None:
            w = torch.where(mask, w, torch.zeros_like(w))
            lanes = torch.arange(idx.shape[0], device=idx.device)
            store = torch.where(mask, idx, N + lanes)
        new_gvec, opt_state = aggregator.aggregate_flat(
            state.params, rows, w, state.opt_state)
        state.client_params.index_copy_(0, store, rows)
        state.params.copy_(new_gvec)
        return state._replace(opt_state=opt_state)

    def train_aggregate(state, idx, mask, images, labels, sizes, batch_idx):
        with record_function("fl.train"):
            rows = train_rows(state, idx, images, labels, batch_idx)
        with record_function("fl.aggregate"):
            return fold(state, idx, mask, rows, sizes)

    def cluster_round(state, images, labels, sizes, batch_idx, draws):
        """All devices train and fold, then K-means on the feature layer
        (seeded from ``draws``) into ``state.labels``."""
        all_idx = torch.arange(N, device=state.params.device)
        state = train_aggregate(state, all_idx, None, images, labels, sizes,
                                batch_idx)
        feats = extract_features_flat(state.client_params[:N], feature_layer,
                                      spec)
        _, k_labels, _ = kmeans_fit(feats, tctx.num_clusters, draws=draws)
        state.labels.copy_(k_labels)
        return state

    def init_round(state, images, labels, sizes, batch_idx, arr,
                   test_images, test_labels, draws):
        """Round 0: :func:`cluster_round`, evaluate, allocate over all N."""
        state = cluster_round(state, images, labels, sizes, batch_idx, draws)
        acc, per_class = evaluate_row(state.params, test_images, test_labels)
        T, E, b, _ = allocator.allocate_traced(arr, B, None)
        return state, InitOutputs(accuracy=acc, T=T, E=E, band=torch.sum(b),
                                  per_class=per_class)

    def select_phase(state, arr, draw=None):
        """Divergence (rows ``[:N]`` of the plane) → select."""
        with record_function("fl.select"):
            if selector.needs_divergence:
                div = weight_divergence_flat(state.client_params[:N],
                                             state.params)
            else:
                div = torch.zeros((N,), dtype=torch.float32,
                                  device=state.params.device)
            return selector.select_traced(draw, div, state.labels, arr, tctx)

    def finish_phase(state, arr, idx, mask, images, labels, sizes,
                     batch_idx, test_images, test_labels):
        """allocate → train → fold → evaluate for one selection."""
        with record_function("fl.allocate"):
            t = clamp(idx)
            arr_sel = {k: v[t] for k, v in arr.items()}
            T, E, b, _ = allocator.allocate_traced(arr_sel, B, mask)
        state = train_aggregate(state, idx, mask, images, labels, sizes,
                                batch_idx)
        with record_function("fl.evaluate"):
            acc, per_class = evaluate_row(state.params, test_images,
                                          test_labels)
        return state, RoundOutputs(accuracy=acc, T=T, E=E, selected=idx,
                                   mask=mask, band=masked_sum(b, mask),
                                   per_class=per_class)

    return SimpleNamespace(
        spec=spec, N=N, B=B, local_iters=cfg.local_iters, batch_size=cfg.batch_size,
        allocator=allocator, aggregator=aggregator,
        evaluate_row=evaluate_row, train_rows=train_rows, fold=fold,
        train_aggregate=train_aggregate, cluster_round=cluster_round,
        init_round=init_round, select_phase=select_phase,
        finish_phase=finish_phase)


class RoundInputs(NamedTuple):
    """What a round reads besides the carry and the batch indices."""
    images: Any
    labels: Any
    sizes: Any
    arr: Dict[str, Any]
    test_images: Any
    test_labels: Any


def _clone(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: v.clone() for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_clone(v) for v in x))
    return x.clone()


def _copy_into(dst, src):
    if dst is None:
        return
    if isinstance(dst, dict):
        for k, v in dst.items():
            v.copy_(src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        dst.copy_(src)


class TracedProgram:
    """One strategy bundle's round body on one device at one set of shapes
    (the reference's scanned program).

    A call ``prog(state, images, labels, sizes, arr, test_images,
    test_labels, draws=, rounds=, with_init=)`` runs the initial round
    (``with_init``), then ``rounds`` rounds, and returns a
    :class:`TracedRunResult`. ``draws`` gives the initial round's batch
    indices and K-means seeding, then every round's ``[S_pad, L, batch]``
    batch indices, all drawn before the first round in the host loop's
    order.

    On the card the program owns static copies of the carry and the
    inputs: a call loads them by device copies, runs the initial round
    eagerly (its solve is SAO's own, a graph from its second call on)
    and replays the captured
    round once a round, copying the round's batch indices into the
    graph's input first; no step reads back to the host. The first call
    captures the round (after one warm-up round on a side stream, which
    builds and loads the kernels) and records ``capture_ms``. Kernel
    wrappers count their launches at the capture, never on a replay. On
    the CPU the round body runs eagerly on the caller's tensors.
    """

    def __init__(self, ph, device: torch.device, pad: int):
        self.ph = ph
        self.device = device
        self.pad = pad                  # the selector's lanes a round
        self.graph = None
        self.capture_ms = None

    def round_body(self, state, inputs: RoundInputs, batch_idx):
        """One round, eagerly: select, then allocate, train, fold and
        evaluate. Returns ``(state, RoundOutputs)``."""
        idx, mask = self.ph.select_phase(state, inputs.arr)
        return self.ph.finish_phase(state, inputs.arr, idx, mask,
                                    inputs.images, inputs.labels,
                                    inputs.sizes, batch_idx,
                                    inputs.test_images, inputs.test_labels)

    def _batch_shape(self):
        return (self.pad, self.ph.local_iters, self.ph.batch_size)

    def capture(self, state: RoundState, inputs: RoundInputs) -> None:
        """Capture the round over static copies of ``state`` and
        ``inputs`` (whose values the warm-up and the capture overwrite)."""
        self.state, self.inputs = _clone(state), _clone(inputs)
        self.batch = torch.zeros(self._batch_shape(), dtype=torch.long,
                                 device=self.device)
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side), eager_solves():
            self.round_body(self.state, self.inputs, self.batch)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _, self.out = self.round_body(self.state, self.inputs, self.batch)
        torch.cuda.synchronize(self.device)
        self.graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def load(self, state: RoundState, inputs: RoundInputs) -> None:
        """Copy ``state`` and ``inputs`` into the graph's static tensors
        (device copies: nothing waits for the card)."""
        _copy_into(self.state, state)
        _copy_into(self.inputs, inputs)

    def replay(self, batch_idx) -> RoundOutputs:
        """One captured round on the static carry: load ``batch_idx``,
        replay; the outputs are the graph's (the next replay overwrites
        them)."""
        self.batch.copy_(batch_idx)
        self.graph.replay()
        return self.out

    def __call__(self, state: RoundState, images, labels, sizes, arr,
                 test_images, test_labels, *, draws, rounds: int,
                 with_init: bool) -> TracedRunResult:
        ph = self.ph
        inputs = RoundInputs(images, labels, sizes, dict(arr), test_images,
                             test_labels)
        if self.device.type == "cuda":
            if self.graph is None:
                self.capture(state, inputs)
            self.load(state, inputs)
            state, inputs = self.state, self.inputs
        n_samples = inputs.images.shape[1]
        init = None
        if with_init:
            batch0 = draws.batch_indices(ph.N, ph.local_iters,
                                         ph.batch_size, n_samples)
            state, init = ph.init_round(state, inputs.images, inputs.labels,
                                        inputs.sizes, batch0, inputs.arr,
                                        inputs.test_images,
                                        inputs.test_labels, draws)
        batches = [draws.batch_indices(*self._batch_shape(), n_samples)
                   for _ in range(rounds)]
        outs = []
        for batch_idx in batches:
            if self.graph is not None:
                out = _clone(self.replay(batch_idx))
            else:
                state, out = self.round_body(state, inputs, batch_idx)
            outs.append(out)
        stacked = (RoundOutputs(*(torch.stack(v) for v in zip(*outs)))
                   if outs else None)
        return TracedRunResult(state=state, rounds=stacked, init=init)


# LRU-bounded: a captured program holds its graph's memory pool and static
# copies of the carry, so sweeps over many bundles or shapes keep only the
# most recent few
_RUN_FN_CACHE: "OrderedDict[tuple, TracedProgram]" = OrderedDict()
_RUN_FN_CACHE_MAX = 8


def aggregator_cache_key(aggregator) -> tuple:
    """Hashable identity of an aggregator instance."""
    return (aggregator.registry_name,
            tuple(sorted(aggregator.params().items())))


def shapes_key(tensors) -> tuple:
    """The shapes and dtypes of ``tensors``, as :func:`run_rounds` keys
    its programs."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def run_rounds(cfg: EngineConfig, *, selector, allocator, aggregator,
               tctx: TracedContext, feature_layer: str, device,
               shapes: tuple, base=None) -> TracedProgram:
    """The device-resident program for one strategy bundle on ``device``
    at ``shapes`` (the shapes of the data it reads: :func:`shapes_key` of
    images, labels, sizes, test images, test labels), cached process-wide
    (LRU), so runs that differ only in seed or data replay one captured
    round.

    A stochastic selector raises naming the port: its traced draw has no
    source in the port's run yet (the host loop runs it). The reference's
    other options (compressors, channels, cells, cohorts, faults) are no
    fields of the port's spec, and its registries refuse the strategies it
    lacks, naming the port.
    """
    if getattr(selector, "needs_rng", True):
        _not_ported(f"the traced draw of the stochastic selector "
                    f"{getattr(selector, 'registry_name', selector)!r} "
                    "(FLExperiment.run() takes the host loop for it)")
    device = torch.device(device)
    base_key = (None if base is None
                else tuple(v.data_ptr() for v in base.values()))
    key = (cfg, selector, allocator, aggregator_cache_key(aggregator), tctx,
           feature_layer, device, shapes, base_key)
    prog = _RUN_FN_CACHE.get(key)
    if prog is None:
        ph = build_round_phases(cfg, aggregator, selector, allocator, tctx,
                                feature_layer, base)
        prog = _RUN_FN_CACHE[key] = TracedProgram(ph, device,
                                                  selector.pad_size(tctx))
        while len(_RUN_FN_CACHE) > _RUN_FN_CACHE_MAX:
            _RUN_FN_CACHE.popitem(last=False)
    else:
        _RUN_FN_CACHE.move_to_end(key)
    return prog
