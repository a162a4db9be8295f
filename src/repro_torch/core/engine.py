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

Under a fault spec (``repro_torch.core.faults``) every selection round
injects its failures after training — lost uploads, NaN rows, byzantine
rows, stragglers past a deadline — with the round's fault draw a graph
input beside the batch indices; the non-finite guard and the counts in
the stats table ride the same body, as does quarantine in selection, so
the host loop and the captured round stay one computation.

The buffered-asynchronous engine (``repro_torch.core.async_engine``:
FedBuff ticks, churn) builds its tick from the same closures and is
captured and replayed the same way, its churn draws graph inputs like the
fade.

The wireless scenario rides the same body: a fading channel
(``repro_torch.api.scenario``) steps its carried state at the start of
each round from a CN(0,1) draw handed in like the selector's, so the
selector sees the round's gains; an uplink compressor quantizes the
trained rows before the fold; a multi-cell cohort under selection-driven
interference (``multicell-dynamic``) reduces, each round, the cross gains
of the devices the other cells selected into each cell's ``inr`` before
the allocator.

Every function of the round body also takes a leading lane axis (a
cohort's seeds — and cells — ``repro_torch.core.cohort``, where the
reference ``vmap``s the scanned run): a ``[B, P]`` global row, a ``[B, N + pad, P]``
plane, ``[B, ...]`` data, draws and fleet arrays. The single run is one
lane with today's shapes through the same code; a cohort is B lanes of
ONE captured round, replayed once a round for all of them. Local
training runs lane by lane inside it: each lane's S clients as one stack,
the products of its single run at their shapes, so a lane computes its
single run's bits (one ``[B·S_pad]`` stack would not: cuBLAS picks its
kernels by the batch count).

Over several mesh positions (a mesh may name one device more than once:
work is keyed by position, never by device), the same body runs two
ways. A seed cohort runs one program a position over its own lanes
(:func:`run_programs` drives them side by side, round by round, with no
host sync between). A single run with ``p_shards = m`` keeps the plane as
``m`` column blocks (``repro_torch.sharding.blocks.ColumnBlocks``): the
lead position runs the round, stages the rows it trained, and each
position writes its columns and reduces its partial divergence (the
body's ``flush``); on the card the lead's round and each position's
flush are captured as separate graphs, ordered by stream events.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import time
from collections import OrderedDict
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.api.protocols import RoundState, TracedContext
from repro_torch.core.clustering import (extract_features_flat, kmeans_fit,
                                         resolve_feature_columns)
from repro_torch.core.divergence import weight_divergence_flat
from repro_torch.core.faults import chan_outage_threshold, draw_fault_masks
from repro_torch.core.graphs import eager_solves
from repro_torch.core.wireless import completion_times, masked_sum
from repro_torch.kernels import ops
from repro_torch.models.registry import model_def_for
from repro_torch.sharding.blocks import ColumnBlocks
from repro_torch.utils import spans
from repro_torch.utils.spans import span
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


@functools.lru_cache(maxsize=64)
def model_eval(model_cfg):
    """The reference's name and signature: :func:`model_evaluate` with
    no frozen base, cached per config."""
    return model_evaluate(model_cfg)


# ---------------------------------------------------------------------------
# the device-resident run: one round body, replayed
# ---------------------------------------------------------------------------


class RoundOutputs(NamedTuple):
    """What a round leaves in the history: ``[R]`` / ``[R, S_pad]`` /
    ``[R, classes]`` once stacked. ``band`` is Σ b_n of the allocation;
    ``inr`` the round's selection-driven I/N0 at each lane's BS (a
    dynamic-interference cohort only, else ``None``). The last three are
    the buffered-asynchronous engine's per-tick traces: the updates the
    buffer folded, their mean age at the fold and the available fleet's
    size (``None`` on a synchronous run). ``kept`` marks, under an active
    fault spec, the lanes whose trained rows reached the store (``None``
    otherwise)."""
    accuracy: Any
    T: Any
    E: Any
    selected: Any
    mask: Any
    band: Any
    per_class: Any
    inr: Any = None
    participation: Any = None
    staleness: Any = None
    active: Any = None
    kept: Any = None


class InitOutputs(NamedTuple):
    """The initial (all-device) round's bookkeeping."""
    accuracy: Any
    T: Any
    E: Any
    band: Any
    per_class: Any


class TracedRunResult(NamedTuple):
    """Everything one traced run returns, still on the device. ``state``
    is the program's carry (an asynchronous run's with its stats table,
    ``state.sched``): copy out what outlives the next run."""
    state: RoundState
    rounds: Optional[RoundOutputs]       # None for rounds = 0
    init: Optional[InitOutputs] = None   # None without the initial round


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what}: not in the PyTorch port (repro_torch) yet")


def selector_draw_kind(selector) -> Optional[str]:
    """The draw a selector takes each round on the device-resident run:
    ``None`` for a deterministic one, else its ``draw_kind``; a
    stochastic selector that names none raises naming the port."""
    if not getattr(selector, "needs_rng", True):
        return None
    kind = getattr(selector, "draw_kind", None)
    if kind is None:
        _not_ported(f"the traced draw of the stochastic selector "
                    f"{getattr(selector, 'registry_name', selector)!r} "
                    "(it names no draw_kind)")
    return kind


def lane_rows(x, idx):
    """``x[idx]`` along the client axis: ``x [N, ...]`` at ``idx [S]``, or
    lane by lane, ``x [B, N, ...]`` at ``idx [B, S]`` (lane b's rows of
    its own ``x[b]``)."""
    if idx.dim() == 1:
        return x[idx]
    lanes = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return x[lanes, idx]


def lane_view(tree, b: int):
    """Lane ``b`` of a lane-stacked carry or input (views: an in-place
    update of the lane writes the stack)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: lane_view(v, b) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(lane_view(v, b) for v in tree))
    return tree[b]


def build_round_phases(cfg: EngineConfig, aggregator, selector, allocator,
                       tctx: TracedContext, feature_layer: str, base=None,
                       *, compressor=None, channel=None, cells: int = 1,
                       plane: str = "full", faults=None,
                       quarantine_after: int = 0, byzantine=None):
    """The closures a round is made of (the reference's
    ``build_round_phases``), over a :class:`RoundState` they update in
    place:

    ``init_channel``/``step_channel`` (a fading channel's state: h_0, then
    one AR(1) step a round from the draw handed in), ``train_gathered``
    (local SGD of clients' data already gathered, then the
    ``compressor``), ``train_rows`` (the same for an index set),
    ``store_rows`` (the rows into the plane), ``fold`` (``store_rows`` +
    the eq.-(4) masked fold), ``train_aggregate``
    (the two), ``cluster_round`` (Alg. 1 line 1 + Alg. 2: all devices
    train and fold, K-means), ``init_round`` (``cluster_round``, then
    evaluate, fade and allocate over all N), ``select_phase`` (fade →
    divergence → select; returns the faded arrays), ``cross_inr``
    (selection-driven interference), ``finish_phase`` (allocate → train
    → fold → evaluate), ``evaluate_row`` and ``evaluate_rows``. ``mask =
    None`` marks a selection with no padding (the host loop's, and the
    all-device round's).

    Each takes the carry either as one run's or lane-stacked (a cohort's:
    ``state.params`` of ``[B, P]``), with its inputs to match; only
    ``cluster_round`` is one lane's (``init_round`` runs it lane by lane,
    each lane's K-means on its own draws). ``cells > 1`` (a dynamic
    channel's cohort): lane ``s·cells + c`` is seed s's cell c, and
    ``cross_inr`` couples each seed's cells.

    ``plane`` is what client state the carry holds: ``"full"``, the plane
    with a spare row for each lane (``[N + S_pad, P]``: the device-resident
    run's and the dense tick's carry; divergence is its row reduction);
    ``"rows"``, a plane of exactly its clients (the host loop's ``[N,
    P]``, a paged round's active plane), which no padding lane reaches;
    ``"stats"``, the per-client stats
    table alone (``state.sched``, the paged store's asynchronous ticks):
    ``select_phase`` reads ``state.sched.divergence`` and the caller
    persists the rows ``train_gathered`` gives through its store.

    A ``"full"`` plane may be a :class:`ColumnBlocks` (``p_shards``: one
    column block a mesh position, one run's carry): ``store_rows`` then
    stages the rows on the lead, ``flush`` (after the round, and inside
    ``cluster_round`` before K-means) hands each position its columns and
    the global row's, where ``shard_step`` writes them and reduces its
    partial divergence, and ``select_phase`` sums the partials on the
    lead in position order; the K-means features are gathered from the
    blocks that hold their columns.

    Padding lanes hold the sentinel N: data is gathered at ``min(idx,
    N − 1)`` (JAX clamps a gather), their weight is 0, and lane j's row is
    written to plane row ``N + j``, which nothing reads (JAX drops an
    out-of-bounds scatter); in a cohort, of the cohort lane's own plane.
    Every index of the write is then distinct, so its result does not
    depend on the order of the writes. The compressor sees the padding
    rows too (a block's scale and top-k threshold span all ``S_pad``
    rows, as the reference's do).

    ``faults`` (a ``repro_torch.core.faults.FaultSpec``) arms the fault
    phase of every selection round (``finish_phase``; the all-device
    round never): after training, the round's fault draw (``fault``,
    ``[2, S]`` bool: drop, corrupt) drops uploads (i.i.d., under a deep
    fade of the stateful channel, or past the ``deadline`` on the
    round's own completion times), corrupts rows to NaN and turns the
    ``byzantine`` clients' rows (a host ``[N]`` bool mask) adversarial;
    lost rows are weighted out of the fold, corrupted ones by the
    non-finite guard, which strikes their senders, and neither reaches
    the plane; ``sched.faults`` and ``sched.strikes`` count them. When no
    upload survives, the global row and the server state pass through
    (a tensor ``where``). ``quarantine_after > 0`` drops clients with as
    many strikes from every selection, like ``avail=False``. Both need
    the stats table in the carry (``sched``), and one run's carry (no
    lane axis).
    """
    if plane not in ("full", "rows", "stats"):
        raise ValueError(f"unknown carry plane {plane!r}; expected 'full', "
                         "'rows' or 'stats'")
    if compressor is None:
        from repro_torch.api.registry import COMPRESSORS
        compressor = COMPRESSORS.resolve("none")
    local_update = local_update_for(cfg, base)
    spec = model_flat_spec(cfg.model_cfg)
    evaluate = model_evaluate(cfg.model_cfg, base)
    N, B = tctx.num_devices, tctx.bandwidth_mhz
    channel_stateful = bool(getattr(channel, "stateful", False))
    channel_rng = bool(getattr(channel, "needs_rng", False))
    fading = channel_stateful or channel_rng
    dynamic = cells > 1 and bool(getattr(channel, "dynamic", False))
    faults_on = faults is not None and faults.active
    track_faults = faults_on or quarantine_after > 0
    if faults_on and faults.chan_outage > 0.0 and not channel_stateful:
        raise ValueError(
            "chan_outage faults derive the drop probability from the fade "
            "state riding the carry; configure a stateful channel "
            "(e.g. 'gauss-markov')")
    byz_host = None
    if faults_on and faults.byzantine > 0.0:
        if byzantine is None or len(byzantine) != N:
            raise ValueError("byzantine faults need the [N] adversarial "
                             "subset (faults.byzantine_clients)")
        # one False sentinel lane, so the padding lanes' N stays honest
        byz_host = np.concatenate([np.asarray(byzantine, bool),
                                   np.zeros(1, bool)])
    byz_on = {}                 # the subset on each device, copied once

    def clamp(idx):
        return torch.clamp(idx, max=N - 1)

    def byz_lanes(idx):
        """The lanes of ``idx`` (global client ids, the sentinel N
        allowed) whose senders are byzantine."""
        dev = idx.device
        if dev not in byz_on:
            byz_on[dev] = torch.as_tensor(byz_host).to(dev)
        return byz_on[dev][idx]

    def byz_transform(idx, gvec, rows):
        """The byzantine lanes' rows as ``g − byz_scale·(w − g)``: finite
        but extreme, so only a robust fold defends against them."""
        g = gvec[..., None, :]
        return torch.where(byz_lanes(idx)[..., None],
                           g - faults.byz_scale * (rows - g), rows)

    def add_counts(col, idx, mask, ev):
        """``col`` with ``ev`` added at ``idx`` (0/1 adds: their order
        leaves the bits alone), padding lane j (off ``mask``) at column
        ``len(col) + j`` of a longer copy, cut off after: a new tensor."""
        n = col.shape[-1]
        store = idx
        if mask is not None:
            pads = torch.arange(idx.shape[-1], device=idx.device)
            store = torch.where(mask, idx, n + pads)
        ext = torch.cat([col, torch.zeros(idx.shape, dtype=col.dtype,
                                          device=col.device)], dim=-1)
        return ext.scatter_add(-1, store, ev.to(col.dtype))[..., :n]

    def inject_faults(state, idx, mask, rows, w, fault, d=None,
                      clients=None):
        """The post-train fault phase (the reference's ``inject_faults``):
        the drawn drops and corruptions, the channel-coupled and deadline
        drops, the byzantine transform. Returns the (corrupted,
        transformed) rows, the weights with lost uploads at 0 and the
        lanes whose rows may reach the plane (byzantine rows do: the
        adversary's state is real)."""
        drop, corrupt = fault[0], fault[1]
        if faults.chan_outage > 0.0:
            # unit-mean exponential fade power of the carry: the upload
            # fails exactly when this round's fade is deep
            gain = torch.sum(torch.square(state.channel), dim=-1)
            drop = drop | (gain[clamp(idx)]
                           < chan_outage_threshold(faults.chan_outage))
        if faults.deadline > 0.0 and d is not None:
            drop = drop | (d > faults.deadline)
        if byz_host is not None:
            rows = byz_transform(idx if clients is None else clients,
                                 state.params, rows)
        if faults.corrupt > 0.0:
            rows = torch.where(corrupt[..., None],
                               torch.full((), float("nan"),
                                          device=rows.device), rows)
        ev = drop | corrupt
        keep = ~ev
        if mask is not None:
            ev, keep = ev & mask, keep & mask
        state.sched.faults.copy_(add_counts(state.sched.faults, idx, mask,
                                            ev))
        return rows, torch.where(drop, torch.zeros_like(w), w), keep

    def finite_guard(state, idx, mask, rows, w):
        """The receive-side non-finite guard: a NaN/Inf row is weighted
        out of the fold and STRIKES its sender (``quarantine_after``
        strikes keep a client out of selection)."""
        finite = torch.all(torch.isfinite(rows), dim=-1)
        state.sched.strikes.copy_(add_counts(state.sched.strikes, idx, mask,
                                             ~finite & (w > 0.0)))
        return torch.where(finite, w, torch.zeros_like(w))

    def evaluate_row(gvec, test_images, test_labels):
        """``(accuracy, per_class)`` tensors of the global row ``gvec``."""
        return evaluate(unflatten_vector(spec, gvec), test_images,
                        test_labels)

    def evaluate_rows(gvec, test_images, test_labels, images):
        """:func:`evaluate_row` of ``gvec [P]``, or of each lane's row of
        ``gvec [B, P]`` — one evaluation a lane, stacked — on the test set
        all lanes share or, when it carries the lane axis too (one axis
        less than the clients' lane-stacked ``images [B, N, n, ...]``, as
        theirs carry the client axis), on lane b's own ``test_*[b]``."""
        if gvec.dim() == 1:
            return evaluate_row(gvec, test_images, test_labels)
        own = test_images.dim() == images.dim() - 1
        outs = [evaluate_row(g, test_images[b] if own else test_images,
                             test_labels[b] if own else test_labels)
                for b, g in enumerate(gvec)]
        return tuple(torch.stack(v) for v in zip(*outs))

    def gathered_rows(state, images_sel, labels_sel, batch_idx):
        """Local SGD from the global row of clients whose data is
        ``images_sel [S, ...]``: ``[S, P]``."""
        params = unflatten_vector(spec, state.params)
        stacked = local_update(params, images_sel, labels_sel, batch_idx)
        return flatten_stacked(spec, stacked)                 # [S_pad, P]

    def local_rows(state, idx, images, labels, batch_idx):
        """Local SGD of the clients ``idx`` from the global row: ``[S,
        P]``."""
        t = clamp(idx)
        return gathered_rows(state, images[t], labels[t], batch_idx)

    def train_gathered(state, images_sel, labels_sel, batch_idx):
        """:func:`train_rows` of data already gathered (one run's): the
        paged store's tick trains its cohort's rows, gathered by the host
        at ``min(idx, N − 1)``, and writes no plane."""
        return compressor.apply_flat(
            gathered_rows(state, images_sel, labels_sel, batch_idx),
            state.params, spec)

    def train_rows(state, idx, images, labels, batch_idx):
        """Local SGD of the clients ``idx`` from the global row, then the
        uplink compressor: rows ``[S, P]``. A cohort's ``idx [B, S]``
        trains lane by lane (rows ``[B, S, P]``), each lane's S clients
        from its own row as one stack — its single run's products at
        their shapes, so its bits — and compresses each lane's block on
        its own."""
        if idx.dim() > 1:
            rows = torch.stack([
                local_rows(lane_view(state, b), idx[b], images[b], labels[b],
                           batch_idx[b]) for b in range(idx.shape[0])])
        else:
            rows = local_rows(state, idx, images, labels, batch_idx)
        return compressor.apply_flat(rows, state.params, spec)

    def store_rows(state, idx, mask, rows, keep=None):
        """Write ``rows`` into the plane at ``idx``. A lane that must not
        land — a padding lane (off ``mask``), a lost or corrupted upload
        (off ``keep``, which implies ``mask``) — goes to the spare row
        ``N + j`` of a ``plane="full"`` carry; on a ``plane="rows"`` plane
        (its lanes distinct clients) its row is written back as it was."""
        land = mask if keep is None else keep
        store = idx
        target = state.client_params
        if land is not None:
            if plane == "rows":
                rows = torch.where(land[..., None], rows,
                                   lane_rows(target, idx))
            else:
                pads = torch.arange(idx.shape[-1], device=idx.device)
                store = torch.where(land, idx, N + pads)
        if isinstance(target, ColumnBlocks):
            # each position writes its columns at the next flush
            target.stage(store, rows)
            return
        if store.dim() > 1:         # cohort lane b writes its own plane b
            lanes = torch.arange(store.shape[0], device=store.device)
            store = store + target.shape[-2] * lanes[:, None]
        target.view(-1, target.shape[-1]).index_copy_(
            0, store.reshape(-1), rows.reshape(-1, rows.shape[-1]))

    def shard_step(plane, i, store, rows, gslice):
        """Position ``i``'s part of a flush, on its own device: the staged
        ``rows`` into its block at ``store`` (none where ``store`` is
        ``None``), then its partial ``Σ(x − g)²`` over its columns of the
        first N rows (``pairwise_l2``'s one-centroid kernel on the card;
        ``None`` where the selector reads no divergence)."""
        blk = plane.blocks[i]
        if store is not None:
            blk.index_copy_(0, store, rows)
        if not selector.needs_divergence:
            return None
        return ops.client_divergence_sq(blk[:N], gslice)

    def flush(state, write=True):
        """A column-block plane's staged writes (``write``) and partial
        divergences against the global row: each position's hand-off
        moved to its device, its :func:`shard_step`, its partial back to
        the lead. A no-op for a whole plane."""
        plane = state.client_params
        if not isinstance(plane, ColumnBlocks):
            return
        lead = state.params.device
        if plane.partials is None and selector.needs_divergence:
            plane.partials = [torch.zeros(N, dtype=torch.float32,
                                          device=lead) for _ in plane.blocks]
        for i, dev in enumerate(plane.devices):
            store, rows, gslice = plane.handoff(
                i, state.params, plane.pending if write else None)
            part = shard_step(
                plane, i, None if store is None else store.to(dev),
                None if rows is None else rows.to(dev), gslice.to(dev))
            if part is not None:
                plane.partials[i].copy_(part)

    def divergence_of_blocks(plane):
        """``[N]`` divergences from the positions' partials, summed on the
        lead in position order."""
        total = plane.partials[0]
        for part in plane.partials[1:]:
            total = total + part
        return torch.sqrt(total)

    def fold(state, idx, mask, rows, sizes, armed=False, fault=None, d=None,
             clients=None):
        """The eq.-(4) fold of ``rows`` into the global row, then
        :func:`store_rows`; ``armed`` (a selection round under faults or
        quarantine) runs the fault phase and the non-finite guard first,
        ``kept`` the lanes that reached the plane (``None`` unless faults
        are on). ``clients``: the lanes' global ids where ``idx`` indexes
        an active plane. Returns ``(state, kept)``."""
        w = lane_rows(sizes, clamp(idx))
        if mask is not None:
            w = torch.where(mask, w, torch.zeros_like(w))
        keep = None
        if armed and faults_on:
            if fault is None:
                raise ValueError("a faulty round needs its fault draw "
                                 "(faults.draw_fault_masks)")
            rows, w, keep = inject_faults(state, idx, mask, rows, w, fault,
                                          d, clients)
        if armed:
            w = finite_guard(state, idx, mask, rows, w)
        new_gvec, opt_state = aggregator.aggregate_flat(
            state.params, rows, w, state.opt_state)
        if armed:
            # all failed: the global row and the server state pass through
            # instead of folding an empty (zeroed) cohort
            any_ok = torch.any(w > 0.0, dim=-1, keepdim=True)
            new_gvec = torch.where(any_ok, new_gvec, state.params)
            if opt_state is not None:
                opt_state = torch.where(any_ok, opt_state, state.opt_state)
        store_rows(state, idx, mask, rows, keep)
        state.params.copy_(new_gvec)
        if opt_state is not None:
            # in place, as the global row: a captured round's next replay
            # reads the carry's own tensors (FedAvgM's momentum)
            state.opt_state.copy_(opt_state)
        return state, keep

    def train_aggregate(state, idx, mask, images, labels, sizes, batch_idx,
                        **arms):
        """Train ``idx``, then :func:`fold` (``arms``: its fault
        arguments). Returns ``(state, kept)``."""
        dev = state.params.device
        with span("fl.train", dev):
            rows = train_rows(state, idx, images, labels, batch_idx)
        with span("fl.aggregate", dev):
            return fold(state, idx, mask, rows, sizes, **arms)

    def cluster_round(state, images, labels, sizes, batch_idx, draws):
        """All devices train and fold, then K-means on the feature layer
        (seeded from ``draws``) into ``state.labels``. One lane's."""
        all_idx = torch.arange(N, device=state.params.device)
        state, _ = train_aggregate(state, all_idx, None, images, labels,
                                   sizes, batch_idx)
        plane = state.client_params
        if isinstance(plane, ColumnBlocks):
            flush(state)
            cols = resolve_feature_columns(spec, feature_layer)
            feats = plane.columns(slice(0, spec.total) if cols is None
                                  else cols, N)
        else:
            feats = extract_features_flat(plane[:N], feature_layer, spec)
        with span("fl.kmeans", feats.device):
            _, k_labels, _ = kmeans_fit(feats, tctx.num_clusters,
                                        draws=draws)
        state.labels.copy_(k_labels)
        return state

    def init_channel(state, arr, h0):
        """The carry with a fading channel's state set from its h_0 draw
        (``[N, 2]``, a cohort's ``[B, N, 2]``); stateless channels leave
        it ``None``."""
        if not channel_stateful:
            return state
        return state._replace(channel=channel.init_state(h0, arr))

    def step_channel(state, arr, w):
        """The round's fade from its draw ``w`` (the channel's state
        stepped in place); the faded ``arr``. A no-op without fading."""
        if not fading:
            return arr
        if channel_stateful:
            h, arr = channel.step_traced(w, state.channel, arr)
            state.channel.copy_(h)
            return arr
        return channel.apply_traced(w, arr)

    def fade_draws(draws):
        """One fade draw a lane (``draws``: one draws object, or a
        cohort's sequence), or ``None`` without fading."""
        if not fading:
            return None
        if isinstance(draws, (list, tuple)):
            return torch.stack([d.channel_step((N,)) for d in draws])
        return draws.channel_step((N,))

    def cross_inr(part, xgain):
        """Each lane's I/N0 at its BS, ``[B]``: the ``xgain [B, N, C]``
        rows of the devices the seed's OTHER cells transmit from
        (``part [B, N]`` 0/1; own-cell columns are 0), lanes viewed as
        ``[seeds, cells]``."""
        C = cells
        p = part.reshape(-1, C, N)
        x = xgain.reshape(-1, C, N, C)
        return torch.einsum("scn,scnk->sk", p, x).reshape(-1)

    def participation(idx, mask):
        """``[B, N]`` 0/1: the devices each lane selected (the sentinel N
        of a padding lane matches none)."""
        hit = idx[..., :, None] == torch.arange(N, device=idx.device)
        return torch.any(hit & mask[..., :, None], dim=-2).to(torch.float32)

    def add_inr(arr, inr):
        """``arr`` with the round's ``inr [B]`` added to every device's
        (``None``: unchanged); the solvers fold it into J once."""
        if inr is None:
            return arr
        arr = dict(arr)
        arr["inr"] = arr["inr"] + inr[:, None]
        return arr

    def init_round(state, images, labels, sizes, batch_idx, arr,
                   test_images, test_labels, draws, xgain=None):
        """Round 0: :func:`cluster_round`, evaluate, the round's fade (its
        draw after the K-means draws, as the reference's key splits),
        allocate over all N (a dynamic cohort with every device of the
        other cells interfering). A cohort's carry runs
        :func:`cluster_round` lane by lane, lane b on ``batch_idx[b]``
        and its own draws ``draws[b]``, then evaluates, fades and
        allocates every lane at once."""
        if state.params.dim() == 1:
            state = cluster_round(state, images, labels, sizes, batch_idx,
                                  draws)
        else:
            for b, lane_draws in enumerate(draws):
                cluster_round(lane_view(state, b), images[b], labels[b],
                              sizes[b], batch_idx[b], lane_draws)
        acc, per_class = evaluate_rows(state.params, test_images,
                                       test_labels, images)
        arr = step_channel(state, arr, fade_draws(draws))
        if dynamic:
            arr = add_inr(arr, cross_inr(
                torch.ones(arr["J"].shape, device=arr["J"].device), xgain))
        T, E, b, _ = allocator.allocate_traced(arr, B, None)
        return state, InitOutputs(accuracy=acc, T=T, E=E, band=masked_sum(b),
                                  per_class=per_class)

    def select_phase(state, arr, draw=None, fade=None):
        """Fade → divergence (rows ``[:N]`` of the plane) → select:
        ``(faded arr, idx, mask)``. The fade comes first, so a channel-aware
        selector (``icas``, ``rra``) sees the round's gains; ``draw`` is a
        stochastic selector's (``[N]``, or ``[B, N]`` a cohort lane each),
        ``fade`` the channel's. Under quarantine a client with
        ``quarantine_after`` strikes leaves the selection like an
        unavailable one (its lane masked, at the sentinel N)."""
        with span("fl.select", state.params.device):
            arr = step_channel(state, arr, fade)
            if selector.needs_divergence and plane == "stats":
                div = state.sched.divergence
            elif (selector.needs_divergence
                  and isinstance(state.client_params, ColumnBlocks)):
                div = divergence_of_blocks(state.client_params)
            elif selector.needs_divergence:
                div = weight_divergence_flat(
                    state.client_params[..., :N, :], state.params)
            else:
                div = torch.zeros(state.labels.shape, dtype=torch.float32,
                                  device=state.params.device)
            idx, mask = selector.select_traced(draw, div, state.labels, arr,
                                               tctx)
            if quarantine_after > 0:
                ok = state.sched.strikes < float(quarantine_after)
                okpad = torch.cat([ok, torch.zeros_like(ok[..., :1])],
                                  dim=-1)
                mask = mask & torch.gather(okpad, -1, idx)
                idx = torch.where(mask, idx, torch.full_like(idx, N))
            return arr, idx, mask

    def finish_phase(state, arr, idx, mask, images, labels, sizes,
                     batch_idx, test_images, test_labels, inr=None,
                     fault=None, clients=None):
        """allocate → train → fold → evaluate for one selection; ``inr``
        (``[B]``) adds the round's selection-driven interference before
        the allocator. Under faults or quarantine the fold is armed:
        ``fault`` is the round's fault draw, the deadline reads the
        round's completion times, ``clients`` the lanes' global ids where
        ``idx`` indexes an active plane."""
        dev = state.params.device
        with span("fl.allocate", dev):
            t = clamp(idx)
            arr_sel = add_inr({k: lane_rows(v, t) for k, v in arr.items()},
                              inr)
            T, E, b, f = allocator.allocate_traced(arr_sel, B, mask)
        arms = {}
        if track_faults:
            arms = dict(armed=True, fault=fault, clients=clients)
            if faults_on and faults.deadline > 0.0:
                # eqs. (5)+(8), as the asynchronous tick prices: an update
                # past the deadline is a straggler the server abandons
                arms["d"] = completion_times(arr_sel, b, f, mask)
        state, kept = train_aggregate(state, idx, mask, images, labels,
                                      sizes, batch_idx, **arms)
        with span("fl.evaluate", dev):
            acc, per_class = evaluate_rows(state.params, test_images,
                                           test_labels, images)
        return state, RoundOutputs(accuracy=acc, T=T, E=E, selected=idx,
                                   mask=mask, band=masked_sum(b, mask),
                                   per_class=per_class, inr=inr, kept=kept)

    def round_body(state, arr, xgain, images, labels, sizes, batch_idx,
                   test_images, test_labels, draw=None, fade=None,
                   fault=None):
        """One round: select, then (a dynamic cohort) the cross-cell
        reduction of the round's selections, then allocate, train, fold
        and evaluate. ``arr`` without ``xgain``; ``fault``: the round's
        fault draw. ``(state, RoundOutputs)``."""
        arr, idx, mask = select_phase(state, arr, draw, fade)
        inr = cross_inr(participation(idx, mask), xgain) if dynamic else None
        return finish_phase(state, arr, idx, mask, images, labels, sizes,
                            batch_idx, test_images, test_labels, inr, fault)

    return SimpleNamespace(
        spec=spec, N=N, B=B, local_iters=cfg.local_iters, batch_size=cfg.batch_size,
        allocator=allocator, aggregator=aggregator, compressor=compressor,
        channel=channel, cells=cells, fading=fading, dynamic=dynamic,
        plane=plane, churn_on=False,
        needs_sched=plane == "stats" or track_faults,
        faults=faults, faults_on=faults_on, track_faults=track_faults,
        fault_first=False, byzantine=byz_host is not None,
        byz_transform=byz_transform, add_counts=add_counts,
        evaluate_row=evaluate_row,
        evaluate_rows=evaluate_rows, clamp=clamp,
        train_gathered=train_gathered, train_rows=train_rows,
        store_rows=store_rows, shard_step=shard_step, flush=flush,
        fold=fold,
        train_aggregate=train_aggregate, cluster_round=cluster_round,
        init_channel=init_channel, step_channel=step_channel,
        init_round=init_round, select_phase=select_phase,
        finish_phase=finish_phase, round_body=round_body)


class RoundInputs(NamedTuple):
    """What a round reads besides the carry, the batch indices and the
    selector's draw."""
    images: Any
    labels: Any
    sizes: Any
    arr: Dict[str, Any]
    test_images: Any
    test_labels: Any

    def shapes(self) -> tuple:
        """:func:`shapes_key` of the data (the fleet arrays aside)."""
        return shapes_key((self.images, self.labels, self.sizes,
                           self.test_images, self.test_labels))


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


@contextlib.contextmanager
def sync_guard(device: torch.device):
    """Raise on any host sync with the card inside the block (PyTorch's
    sync debug mode "error", the counterpart of the reference's
    ``jax.transfer_guard_device_to_host("disallow")``); on the CPU there
    is nothing to guard."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


class TracedProgram:
    """One strategy bundle's round body on one device at one set of shapes
    (the reference's scanned program), for one run or for a cohort of
    ``lanes`` lanes (the reference's ``vmap`` of it).

    A call ``prog(state, images, labels, sizes, arr, test_images,
    test_labels, draws=, rounds=, with_init=)`` runs the initial round
    (``with_init``), then ``rounds`` rounds, and returns a
    :class:`TracedRunResult`. ``draws`` — one draws object, or a cohort's
    sequence of one a lane — gives a fading channel's h_0 first, then the
    initial round's batch indices, K-means seeding and fade, then every
    round's churn (an asynchronous tick's: ``churn_step``), fade, selector
    draw (a stochastic selector's: ``draw_kind``), ``[S_pad, L, batch]``
    batch indices and fault draw (under an active fault spec), all drawn
    before the first round, in the order of ``repro_torch.core.draws``. A
    cohort's carry and inputs are lane-stacked (``lanes``: the carry's
    leading axis, set by the call); its test set is one for all lanes or
    one a lane.
    ``arr["xgain"]`` (a dynamic-interference cohort's cross gains) is
    held apart from the arrays the solvers see.

    On the card the program owns static copies of the carry and the
    inputs: a call loads them by device copies, runs the initial round
    eagerly (its solve is SAO's own, a graph from its second call on)
    and replays the captured round once a round for every lane,
    copying the round's fade, selector draw and batch indices into the
    graph's inputs first (and a churning tick's leave and join uniforms,
    a faulty round's fault draw);
    no step reads back to the host.
    ``transfer_guard`` raises on any host sync from the initial round to
    the last replay (sync debug mode "error"; the initial round's solve
    then runs eagerly, as capturing its graph would wait for the card).
    The first call captures the round (after one warm-up round on a side
    stream, which builds and loads the kernels) and records
    ``capture_ms``. Kernel wrappers count their launches at the capture,
    never on a replay. On the CPU the round body runs eagerly on the
    caller's tensors.

    Each phase of the captured round (``fl.select``, ``fl.allocate``,
    ``fl.train``, ``fl.aggregate``, ``fl.evaluate``; a tick's) carries a
    device stamp at its start and end (``repro_torch.utils.spans``,
    ``stamps``), so every replay writes its phases' times to the device's
    stamp ring and nothing else; a call's host stages are spans
    (``fl.call`` … ``fl.replay``), kept while a profiler records.

    A carry whose plane is a :class:`ColumnBlocks` (``p_shards``) is
    captured as one graph for the lead position's round and one a
    position for its flush (``shards``: each on its device's own stream),
    and a replay hands the staged rows and the global row's columns to
    each position, and its partial divergence back, by device copies
    ordered by the streams' events.
    """

    _serials = itertools.count()

    def __init__(self, ph, device: torch.device, pad: int,
                 draw_kind: Optional[str] = None):
        self.ph = ph
        self.device = device
        self.pad = pad                  # the selector's lanes a round
        self.draw_kind = draw_kind      # a stochastic selector's draw
        self.lanes = None               # a cohort's lane count, else None
        self.graph = None
        self.shards = None              # a column-block plane's flushes
        self.capture_ms = None
        self.stamps = None              # the phases' stamps in the graph
        self.serial = next(TracedProgram._serials)

    def round_body(self, state, inputs: RoundInputs, batch_idx, draw=None,
                   fade=None, churn=None, fault=None, flush: bool = True):
        """One round, eagerly: fade, select, (a dynamic cohort: the
        cross-cell interference), allocate, train, fold and evaluate — or
        one asynchronous tick, ``churn`` its leave and join uniforms
        (``[2, N]``, a lane each ``[B, 2, N]``); ``fault`` the round's
        fault draw (``[2, S_pad]``); then (``flush``) a column-block
        plane's flush. Returns ``(state, RoundOutputs)``."""
        arr = dict(inputs.arr)
        xgain = arr.pop("xgain", None)
        extra = {} if churn is None else {"churn": churn}
        if fault is not None:
            extra["fault"] = fault
        state, out = self.ph.round_body(
            state, arr, xgain, inputs.images, inputs.labels, inputs.sizes,
            batch_idx, inputs.test_images, inputs.test_labels, draw, fade,
            **extra)
        if flush:
            self.ph.flush(state)
        return state, out

    def _lead(self) -> tuple:
        return () if self.lanes is None else (self.lanes,)

    def _batch_shape(self):
        return self._lead() + (self.pad, self.ph.local_iters,
                               self.ph.batch_size)

    def _draw_input(self):
        """A valid selector draw for the warm-up and the capture (the
        replays overwrite it): uniforms 0, or the identity permutation."""
        shape = self._lead() + (self.ph.N,)
        if self.draw_kind is None:
            return None
        if self.draw_kind == "permutation":
            return torch.arange(self.ph.N, device=self.device).expand(
                shape).contiguous()
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _fade_input(self):
        """The fade draw's graph input (zeros until a replay loads one)."""
        if not self.ph.fading:
            return None
        return torch.zeros(self._lead() + (self.ph.N, 2),
                           dtype=torch.float32, device=self.device)

    def _churn_input(self):
        """The churn draw's graph input, ``[2, N]`` leave and join
        uniforms (ones until a replay loads one: nobody moves)."""
        if not self.ph.churn_on:
            return None
        return torch.ones(self._lead() + (2, self.ph.N), dtype=torch.float32,
                          device=self.device)

    def _fault_input(self):
        """The fault draw's graph input, ``[2, S_pad]`` (nothing fails
        until a replay loads one)."""
        if not self.ph.faults_on:
            return None
        return torch.zeros(self._lead() + (2, self.pad), dtype=torch.bool,
                           device=self.device)

    def _positions(self) -> tuple:
        """The devices the carry spans: the plane's blocks' (a
        column-block plane), else this program's."""
        plane = self.state.client_params
        if isinstance(plane, ColumnBlocks):
            return plane.devices
        return (self.device,)

    def capture(self, state: RoundState, inputs: RoundInputs) -> None:
        """Capture the round over static copies of ``state`` and
        ``inputs`` (whose values the warm-up and the capture overwrite)."""
        self.state, self.inputs = _clone(state), _clone(inputs)
        self.batch = torch.zeros(self._batch_shape(), dtype=torch.long,
                                 device=self.device)
        self.draw = self._draw_input()
        self.fade = self._fade_input()
        self.churn = self._churn_input()
        self.fault = self._fault_input()
        t0 = time.perf_counter()
        with span("fl.capture", program=self.serial), \
                torch.cuda.device(self.device):
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side), eager_solves():
                # a column-block plane's partials first: the round reads
                # them in its selection
                self.ph.flush(self.state, write=False)
                self.round_body(self.state, self.inputs, self.batch,
                                self.draw, self.fade, self.churn, self.fault)
            current.wait_stream(side)
            for dev in self._positions():
                torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            # a capture stream of this program's own device (the graph
            # class's default stream lives on the device of its first use)
            with spans.capture(self.device) as self.stamps, \
                    torch.cuda.graph(graph,
                                     stream=torch.cuda.Stream(self.device)):
                _, self.out = self.round_body(
                    self.state, self.inputs, self.batch, self.draw,
                    self.fade, self.churn, self.fault, flush=False)
            if isinstance(self.state.client_params, ColumnBlocks):
                self._capture_shards()
            for dev in self._positions():
                torch.cuda.synchronize(dev)
        self.graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _capture_shards(self) -> None:
        """One graph a position of its flush (its write and its partial
        divergence) over static hand-off buffers on its device, captured
        on its own stream; ``_pending`` keeps the lead graph's staged
        rows, which every replay hands on."""
        plane = self.state.client_params
        self._pending = plane.pending
        self.shards = []
        for i, dev in enumerate(plane.devices):
            stage = [torch.empty_like(x, device=dev) for x in
                     plane.handoff(i, self.state.params, self._pending)]
            stream = torch.cuda.Stream(dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.device(dev), torch.cuda.graph(graph,
                                                          stream=stream):
                out = self.ph.shard_step(plane, i, *stage)
            self.shards.append((graph, stream, stage, out))

    def _replay_shards(self) -> None:
        """Each position's flush after the lead's round: its stream waits
        for the lead's, copies the hand-off in, replays its graph and
        copies its partial to the lead; the lead's stream then waits for
        every position's. Nothing waits on the host."""
        plane = self.state.client_params
        lead = torch.cuda.current_stream(self.device)
        for i, (graph, stream, stage, out) in enumerate(self.shards):
            stream.wait_stream(lead)
            with torch.cuda.device(stream.device), torch.cuda.stream(stream):
                for dst, src in zip(stage, plane.handoff(
                        i, self.state.params, self._pending)):
                    dst.copy_(src)
                graph.replay()
                if out is not None:
                    plane.partials[i].copy_(out)
        for _, stream, _, _ in self.shards:
            lead.wait_stream(stream)

    def load(self, state: RoundState, inputs: RoundInputs) -> None:
        """Copy ``state`` and ``inputs`` into the graph's static tensors
        (device copies: nothing waits for the card)."""
        _copy_into(self.state, state)
        _copy_into(self.inputs, inputs)

    def replay(self, batch_idx, draw=None, fade=None, churn=None,
               fault=None) -> RoundOutputs:
        """One captured round on the static carry, every lane at once:
        load ``batch_idx`` (and a stochastic selector's ``draw``, a fading
        channel's ``fade``, a churning tick's ``churn``, a faulty round's
        ``fault``), replay (and each position's flush of a column-block
        plane); the outputs are the graph's (the next replay overwrites
        them)."""
        self.batch.copy_(batch_idx)
        for static, value in ((self.draw, draw), (self.fade, fade),
                              (self.churn, churn), (self.fault, fault)):
            if static is not None:
                static.copy_(value)
        self.graph.replay()
        spans.replayed(self.stamps, program=self.serial)
        if self.shards is not None:
            self._replay_shards()
        return self.out

    def _round_draws(self, lane_draws, n_samples: int):
        """One round's ``(batch indices, selector draw, fade draw, churn
        draw, fault draw)``: per lane, the churn first (an asynchronous
        tick's leave and join uniforms, ``[2, N]``), then the fade, the
        selector's draw and the batch indices, the fault draw after them
        (a tick's before the batch indices, at dispatch); lane-stacked for
        a cohort."""
        ph = self.ph
        batches, draws, fades, churns, faults = [], [], [], [], []
        shape = (self.pad, ph.local_iters, ph.batch_size)
        for d in lane_draws:
            if ph.churn_on:
                churns.append(torch.stack(d.churn_step(ph.N)))
            if ph.fading:
                fades.append(d.channel_step((ph.N,)))
            if self.draw_kind is not None:
                draws.append(d.selector_draw(self.draw_kind, ph.N))
            if ph.faults_on and ph.fault_first:
                faults.append(draw_fault_masks(ph.faults, (self.pad,), d))
            batches.append(d.batch_indices(*shape, n_samples))
            if ph.faults_on and not ph.fault_first:
                faults.append(draw_fault_masks(ph.faults, (self.pad,), d))

        def lanes(x):
            if not x:
                return None
            return x[0] if self.lanes is None else torch.stack(x)
        return (lanes(batches), lanes(draws), lanes(fades), lanes(churns),
                lanes(faults))

    def steps(self, state: RoundState, images, labels, sizes, arr,
              test_images, test_labels, *, draws, rounds: int,
              with_init: bool):
        """The run of a call, in steps, for :func:`run_programs`: a
        generator that yields after the set-up (the capture on the first
        call, the loads), after the initial round and after each round,
        and returns the :class:`TracedRunResult`."""
        ph = self.ph
        inputs = RoundInputs(images, labels, sizes, dict(arr), test_images,
                             test_labels)
        # a cohort's carry is lane-stacked: a [B, P] global row
        self.lanes = (state.params.shape[0] if state.params.dim() > 1
                      else None)
        lane_draws = [draws] if self.lanes is None else list(draws)
        if len(lane_draws) != (self.lanes or 1):
            raise ValueError(f"{len(lane_draws)} draws objects for "
                             f"{self.lanes or 1} lanes")
        if ph.needs_sched and state.sched is None:
            raise ValueError(
                "the buffered-asynchronous engine's carry, and a carry "
                "under faults or quarantine, needs the per-client stats "
                "table (RoundState.sched: ClientStats.device())")
        if ph.fading and getattr(ph.channel, "stateful", False):
            # the fade's h_0, the run's first draw: part of the carry
            h0 = [d.channel_init((ph.N,)) for d in lane_draws]
            state = ph.init_channel(
                state, inputs.arr,
                h0[0] if self.lanes is None else torch.stack(h0))
        if self.device.type == "cuda":
            if self.graph is None:
                self.capture(state, inputs)
            with span("fl.load", program=self.serial):
                self.load(state, inputs)
            state, inputs = self.state, self.inputs
        n_samples = inputs.images.shape[len(self._lead()) + 1]
        yield
        init = None
        if with_init:
            with span("fl.initial_round", program=self.serial):
                batch0 = [d.batch_indices(ph.N, ph.local_iters,
                                          ph.batch_size, n_samples)
                          for d in lane_draws]
                arr0 = dict(inputs.arr)
                xgain = arr0.pop("xgain", None)
                state, init = ph.init_round(
                    state, inputs.images, inputs.labels, inputs.sizes,
                    batch0[0] if self.lanes is None else torch.stack(batch0),
                    arr0, inputs.test_images, inputs.test_labels, draws,
                    xgain)
        else:
            # a column-block plane's partial divergences, against the
            # carry's own row (no staged write)
            ph.flush(state, write=False)
        with span("fl.draws", program=self.serial):
            per_round = [self._round_draws(lane_draws, n_samples)
                         for _ in range(rounds)]
        yield
        outs = []
        for r, (batch_idx, draw, fade, churn, fault) in enumerate(per_round):
            if self.graph is not None:
                with span("fl.replay", program=self.serial, round=r + 1):
                    out = _clone(self.replay(batch_idx, draw, fade, churn,
                                             fault))
            else:
                with span("fl.round", program=self.serial, round=r + 1):
                    state, out = self.round_body(state, inputs, batch_idx,
                                                 draw, fade, churn, fault)
            outs.append(out)
            yield
        stacked = (RoundOutputs(*(None if v[0] is None else torch.stack(v)
                                  for v in zip(*outs)))
                   if outs else None)
        return TracedRunResult(state=state, rounds=stacked, init=init)

    def __call__(self, state: RoundState, images, labels, sizes, arr,
                 test_images, test_labels, *, draws, rounds: int,
                 with_init: bool,
                 transfer_guard: bool = False) -> TracedRunResult:
        with span("fl.call", rounds=rounds):
            return run_programs(
                [(self, (state, images, labels, sizes, arr, test_images,
                         test_labels),
                  dict(draws=draws, rounds=rounds, with_init=with_init))],
                transfer_guard=transfer_guard)[0]


def run_programs(runs, transfer_guard: bool = False) -> list:
    """Several programs' runs side by side — ``runs``: ``(program, args,
    kwargs)`` of a :class:`TracedProgram` call each, one a mesh position —
    and their :class:`TracedRunResult` s in order: every set-up first (the
    captures, the loads), then every initial round, then each round of
    every program before the next round of any, with nothing between
    that waits for a card, so programs on distinct cards run at once.
    ``transfer_guard`` raises on any host sync after the set-ups."""
    gens = [prog.steps(*args, **kwargs) for prog, args, kwargs in runs]
    for gen in gens:
        next(gen)
    guard = contextlib.ExitStack()
    if transfer_guard:
        guard.enter_context(sync_guard(runs[0][0].device))
        guard.enter_context(eager_solves())
    results = [None] * len(gens)
    with guard:
        live = list(enumerate(gens))
        while live:
            going = []
            for i, gen in live:
                try:
                    next(gen)
                    going.append((i, gen))
                except StopIteration as done:
                    results[i] = done.value
            live = going
    return results


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
               shapes: tuple, base=None, compressor=None, channel=None,
               cells: int = 1, churn=None, faults=None,
               quarantine_after: int = 0, byzantine=None, position: int = 0,
               plane_devices: Optional[tuple] = None) -> TracedProgram:
    """The device-resident program for one strategy bundle on ``device``
    at ``shapes`` (the shapes of the data it reads,
    :meth:`RoundInputs.shapes`: a cohort's lane-stacked, its test set one
    for every lane or one a lane), cached process-wide (LRU), so runs that
    differ only in seed or data replay one captured round.

    A stochastic selector takes its draw from the caller's draws object
    (:func:`selector_draw_kind`), as does a fading ``channel``.
    ``compressor`` (default ``none``) quantizes the uplink rows; ``cells >
    1`` (a dynamic-interference cohort, lanes ``seed·cells + cell``)
    couples each seed's cells through the round's cross-cell reduction.

    An async-capable aggregator (``fedbuff:M[:alpha]``) swaps the round
    for the buffered-asynchronous tick (``repro_torch.core.async_engine``)
    — the same program, its rounds virtual-time ticks — and ``churn``
    (``(p_leave, p_join)``, per-tick Bernoulli probabilities) flips the
    availability mask the carry's stats table holds. Churn without such an
    aggregator, and such an aggregator with ``cells > 1``, raise.

    ``faults``, ``quarantine_after`` and ``byzantine`` (the ``[N]``
    adversarial subset) arm the fault-tolerant round or tick
    (``build_round_phases``); its fault draw is a graph input beside the
    batch indices. With ``cells > 1`` they raise, as in the reference.

    ``position``: the mesh position the program serves (a cohort split
    over a mesh runs one program a position, each with its own static
    carry, even where two positions name one device); ``plane_devices``:
    the devices of a column-block plane's positions (``p_shards``), whose
    program captures a flush a position.
    """
    churn = (0.0, 0.0) if churn is None else (float(churn[0]),
                                              float(churn[1]))
    is_async = getattr(aggregator, "async_capable", False)
    if not is_async and churn != (0.0, 0.0):
        raise ValueError(
            "client churn is a property of the buffered-asynchronous "
            "engine; configure an async-capable aggregator "
            "(e.g. 'fedbuff:4') to enable it")
    if is_async and cells > 1:
        raise ValueError(
            "the buffered-asynchronous engine runs single-cell programs "
            "only; run multi-cell fleets with a synchronous aggregator")
    track_faults = ((faults is not None and faults.active)
                    or quarantine_after > 0)
    if track_faults and cells > 1:
        raise ValueError(
            "fault injection / quarantine runs single-cell programs only")
    if compressor is None:
        from repro_torch.api.registry import COMPRESSORS
        compressor = COMPRESSORS.resolve("none")
    if not any(getattr(channel, a, False)
               for a in ("stateful", "needs_rng", "dynamic")):
        channel = None          # static, build-time interference: no hook
    draw_kind = selector_draw_kind(selector)
    device = torch.device(device)
    base_key = (None if base is None
                else tuple(v.data_ptr() for v in base.values()))
    byz_key = (None if byzantine is None
               else np.asarray(byzantine, bool).tobytes())
    key = (cfg, selector, allocator, aggregator_cache_key(aggregator), tctx,
           feature_layer, device, shapes, base_key, compressor, channel,
           cells, churn, faults, quarantine_after, byz_key, position,
           plane_devices)
    prog = _RUN_FN_CACHE.get(key)
    if prog is None:
        arms = dict(faults=faults, quarantine_after=quarantine_after,
                    byzantine=byzantine)
        if is_async:
            from repro_torch.core.async_engine import build_async_phases
            ph = build_async_phases(cfg, aggregator, selector, allocator,
                                    tctx, feature_layer, base,
                                    compressor=compressor, channel=channel,
                                    churn=churn, **arms)
        else:
            ph = build_round_phases(cfg, aggregator, selector, allocator,
                                    tctx, feature_layer, base,
                                    compressor=compressor, channel=channel,
                                    cells=cells, **arms)
        prog = _RUN_FN_CACHE[key] = TracedProgram(
            ph, device, selector.pad_size(tctx), draw_kind)
        while len(_RUN_FN_CACHE) > _RUN_FN_CACHE_MAX:
            _RUN_FN_CACHE.popitem(last=False)
    else:
        _RUN_FN_CACHE.move_to_end(key)
    return prog
