"""CohortRunner — a cohort of seeds (× cells) as lanes of ONE captured
round (``repro.core.cohort``).

The paper's headline figures are sweeps over seeds (× selectors × σ). The
reference stacks the seeds' states on a leading cohort axis and ``vmap``s
its scanned multi-round program over it. The port gives the round body's
tensors that leading lane axis instead (``repro_torch.core.engine``): the
carry is a ``[B, P]`` global row, a ``[B, N + pad, P]`` plane and ``[B,
N]`` labels, the data and fleet arrays are ``[B, ...]``, and on the card
the whole round for every lane is one CUDA graph, replayed once a round —
not B graphs. Each lane's dataset, partition, fleet and draws come from
``build_experiment(spec.replace(seed=s), cell=c)``, so a lane is its
seed's (and cell's) single run; the initial round runs eagerly, lane by
lane (each lane's own K-means), and the history comes back in one
device-to-host transfer.

A multi-cell ``FleetSpec`` gives each seed one lane a cell, lane ``s·C +
c``. Under build-time interference (``multicell-interference``) the lanes
are independent; under selection-driven interference
(``multicell-dynamic``) the round body views the lanes as ``[seeds,
cells]`` for one reduction a round, which couples a seed's cells inside
the same captured round: each BS hears the devices the other cells
selected (the reference's inner cells axis).

    runner = build_cohort(ExperimentSpec(..., cohort=8))
    ch = runner.run()                  # 8 seeds (× cells), one round
    ch.accuracy                        # [8·C, rounds + 1]
    ch.history(3)                      # lane 3 as an FLHistory

The stochastic selectors run here with their draws from each lane's own
draws object (``TorchDraws.selector_draw``), not from the host Generator
of the host loop: a lane is reproducible from its seed and equals its
seed's ``traced_run(..., draws=)``, but not its host-loop run.

An async-capable aggregator (``fedbuff``) makes the captured round the
buffered-asynchronous tick (``repro_torch.core.async_engine``) for every
lane at once: each lane's churn, completion ranks and fire act on its own
``[N]`` columns of the stacked stats table, the fold is one lane-form
``flat_aggregate`` launch, and training stays lane by lane, so a lane is
its seed's single asynchronous run. The history then carries the ticks'
``participation``, ``staleness`` and ``active`` traces.

The reference splits the cohort axis over the host's devices
(``cohort_mesh``, padded by ``_mesh_pad``, placed by ``_shard_cohort``).
Here those are the one-device forms: no mesh, no pad lanes, the lanes as
they are; a cohort of more than one lane on a host of more than one card
raises, as the lanes' split across cards is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import (RoundInputs, TracedRunResult,
                                     lane_view, run_rounds)
from repro_torch.core.fedavg import (FLExperiment, FLHistory, history_parts,
                                     rounds_by_name, to_host)
from repro_torch.core.wireless import fleet_arrays

__all__ = ["CohortHistory", "CohortRunner"]


@dataclass
class CohortHistory:
    """Stacked round histories of a (seeds × cells) cohort; the leading
    axis is the lane ``seed_index · cells + cell``."""
    seeds: List[int]                  # per-lane seed
    accuracy: np.ndarray              # [B, rounds + 1]
    T_k: np.ndarray                   # [B, rounds + 1]
    E_k: np.ndarray                   # [B, rounds + 1]
    selected: np.ndarray              # [B, rounds, S_pad] padded indices
    mask: np.ndarray                  # [B, rounds, S_pad] participation
    with_init: bool
    num_devices: int
    cells: int = 1                    # cells per seed (lane = s·cells + c)
    inr: Optional[np.ndarray] = None  # [B, rounds] the round's selection-
                                      # driven I/N0 at each lane's BS
                                      # (dynamic interference only)
    # the buffered-asynchronous engine's per-tick traces (None on a
    # synchronous cohort), [B, rounds] each
    participation: Optional[np.ndarray] = None  # updates folded
    staleness: Optional[np.ndarray] = None      # their mean age at the fold
    active: Optional[np.ndarray] = None         # the available fleet

    @property
    def lane_cells(self) -> List[int]:
        """Per-lane cell index (parallel to ``seeds``)."""
        return [i % self.cells for i in range(len(self.seeds))]

    def __len__(self) -> int:
        return len(self.seeds)

    def history(self, i: int) -> FLHistory:
        """Lane ``i``'s run as a plain ``FLHistory`` (padding stripped), in
        the reference's layout: accuracy, T_k, E_k and the selections (and
        an asynchronous cohort's traces)."""
        hist = FLHistory()
        hist.accuracy = [float(a) for a in self.accuracy[i]]
        hist.T_k = [float(t) for t in self.T_k[i]]
        hist.E_k = [float(e) for e in self.E_k[i]]
        if self.with_init:
            hist.selected.append(np.arange(self.num_devices))
        hist.selected.extend(self.selected[i][k][self.mask[i][k]]
                             for k in range(self.selected.shape[1]))
        for name in ("participation", "staleness", "active"):
            trace = getattr(self, name)
            if trace is not None:
                setattr(hist, name, [float(x) for x in trace[i]])
        return hist

    @property
    def final_accuracy(self) -> np.ndarray:
        return self.accuracy[:, -1]


def cohort_mesh(cohort_size: int, device="cuda"):
    """The mesh the cohort axis would split over: ``None`` where
    ``min(devices, cohort_size)`` is one (the lanes run on one device). A
    cohort over more than one card raises."""
    dev = torch.device(device)
    n = min(torch.cuda.device_count() if dev.type == "cuda" else 1,
            cohort_size)
    if n <= 1:
        return None
    raise NotImplementedError(
        f"a cohort of {cohort_size} lanes over {n} cards: the split of the "
        "cohort axis across cards is not ported (the lanes run on one card)")


def _mesh_pad(lanes: int, mesh) -> int:
    """How many pad lanes make ``lanes`` divide the mesh's device count."""
    if mesh is None:
        return 0
    return (-lanes) % mesh.devices.size


def _shard_cohort(tree, mesh):
    """Every leaf's leading (cohort) axis on the mesh's devices: on no
    mesh, the tree itself."""
    if mesh is None:
        return tree
    raise NotImplementedError("the cohort axis across cards is not ported")


def _stack(tensors):
    return torch.stack(list(tensors))


def _stack_lanes(parts):
    """One carry slot of every lane stacked on a leading lane axis: a
    tensor, or a table of tensor columns (the stats table), column by
    column; ``None`` stays ``None``."""
    if parts[0] is None:
        return None
    if isinstance(parts[0], tuple):
        return type(parts[0])(*(_stack(col) for col in zip(*parts)))
    return _stack(parts)


class CohortRunner:
    """Run one ``ExperimentSpec`` across a batch of seeds (× the fleet's
    cells) as lanes of one device-resident program on one device.

    ``device`` as for ``build_experiment`` (``cuda`` unless named);
    ``draws``: ``seed -> draws object`` in place of each lane's default
    ``TorchDraws(seed)`` (a parity test replays the reference's key
    streams). Requires every strategy to be traceable
    (``FLExperiment.traceable``) and, with cells, equal device counts
    in every cell. A paged store raises: the cohort's carry is the dense
    plane.
    """

    def __init__(self, spec, device=None,
                 draws: Optional[Callable[[int], object]] = None):
        from repro_torch.api.build import resolve_device
        if getattr(spec, "store", "dense") != "dense":
            raise ValueError(
                "CohortRunner scans the dense [N, P] client plane as a "
                "vmapped carry; a paged ClientStore serves rows on demand "
                "(store.gather / iter_client_trees) through the host "
                "drivers instead — run the seeds one at a time via "
                "build_experiment(spec) / FLExperiment.run")
        self.spec = spec
        self.device = resolve_device(device)
        self.draws = draws
        self.experiments: List[FLExperiment] = []
        self.program = None             # the last run's TracedProgram

    @property
    def num_cells(self) -> int:
        return self.spec.num_cells

    def _build(self, seeds: Sequence[int]) -> List[FLExperiment]:
        from repro_torch.api.build import build_experiment
        exps = [build_experiment(
                    self.spec.replace(seed=s), device=self.device, cell=c,
                    draws=None if self.draws is None else self.draws(s))
                for s in seeds for c in range(self.num_cells)]
        counts = {e.fed.num_clients for e in exps}
        if len(counts) > 1:
            raise ValueError(
                "CohortRunner stacks (seed, cell) lanes into one program; "
                f"all cells need equal device counts, got {counts}")
        return exps

    def run(self, seeds: Optional[Sequence[int]] = None,
            rounds: Optional[int] = None, reuse_experiments: bool = False,
            transfer_guard: bool = False) -> CohortHistory:
        """The initial round and ``rounds`` rounds (default
        ``spec.rounds``) of seeds ``seeds`` (default ``spec.seed ..
        spec.seed + spec.cohort − 1``), one lane each a cell.
        ``reuse_experiments=True`` keeps the lanes' experiments when this
        runner already holds as many (their state continues where it was).
        ``transfer_guard=True`` raises on any host sync with the card from
        the initial round to the last replay (the counterpart of the
        reference's ``jax.transfer_guard_device_to_host("disallow")``).
        Each lane's final carry is loaded back into its experiment
        (``self.experiments``); ``self.program`` is the program the run
        replayed (one captured round for all lanes)."""
        if seeds is None:
            seeds = [self.spec.seed + i
                     for i in range(max(int(self.spec.cohort), 1))]
        seeds = [int(s) for s in seeds]
        cells = self.num_cells
        lane_seeds = [s for s in seeds for _ in range(cells)]
        rounds = rounds or self.spec.rounds
        if reuse_experiments and len(self.experiments) == len(lane_seeds):
            exps = self.experiments
        else:
            exps = self.experiments = self._build(seeds)
        e0 = exps[0]
        if not e0.traceable():
            raise ValueError(
                "CohortRunner needs an all-traceable strategy bundle (the "
                "PyTorch port, repro_torch, runs a cohort on its "
                "device-resident run only); got "
                f"selector={e0.selector.registry_name!r}, "
                f"allocator={e0.allocator.registry_name!r}, "
                f"aggregator={e0.aggregator.registry_name!r}, "
                f"compressor={e0.compressor.registry_name!r}, "
                f"channel={e0.channel.registry_name!r}")
        # a dynamic channel couples each seed's cells inside the round
        prog_cells = (cells if getattr(e0.channel, "dynamic", False)
                      else 1)

        mesh = cohort_mesh(len(exps) // prog_cells, self.device)
        state = _shard_cohort(type(e0.traced_state())(*(
            _stack_lanes(parts)
            for parts in zip(*(e.traced_state() for e in exps)))), mesh)
        lanes = [e.traced_inputs() for e in exps]
        # one evaluation set for the whole cohort iff every seed resolves
        # the same test data (the sweeps' protocol), else one a lane
        shared = len({e.spec.resolved_test_seed for e in exps}) == 1
        inputs = RoundInputs(
            images=_stack(x.images for x in lanes),
            labels=_stack(x.labels for x in lanes),
            sizes=_stack(x.sizes for x in lanes),
            arr=fleet_arrays([e.fleet for e in exps], self.device),
            test_images=(lanes[0].test_images if shared
                         else _stack(x.test_images for x in lanes)),
            test_labels=(lanes[0].test_labels if shared
                         else _stack(x.test_labels for x in lanes)))
        prog = self.program = run_rounds(
            e0.engine_cfg, selector=e0.selector, allocator=e0.allocator,
            aggregator=e0.aggregator, tctx=e0.traced_context(),
            feature_layer=e0.fl.feature_layer, device=self.device,
            shapes=inputs.shapes(), base=e0.base, compressor=e0.compressor,
            channel=e0.channel, cells=prog_cells, churn=e0.churn)
        res = prog(state, *inputs, draws=[e.draws for e in exps],
                   rounds=rounds, with_init=True,
                   transfer_guard=transfer_guard)
        # the whole history and the K-means labels in one transfer
        *vals, lane_labels = to_host(history_parts(res) + [res.state.labels])
        for i, e in enumerate(exps):
            e.load_traced_state(lane_view(res.state, i),
                                labels=lane_labels[i])
        return self._history(lane_seeds, res, vals, e0.fed.num_clients,
                             cells)

    @staticmethod
    def _history(seeds, res: TracedRunResult, vals, num_devices: int,
                 cells: int = 1) -> CohortHistory:
        """``vals``: :func:`history_parts` of a cohort's run on the host —
        the initial round's ``[B]`` values, then the rounds' ``[R, B,
        ...]`` (``inr`` and the asynchronous traces where the run has
        them)."""
        acc0, T0, E0 = (v[:, None] for v in vals[:3])
        r = {k: np.moveaxis(v, 0, 1) for k, v in rounds_by_name(
            res.rounds, vals[len(res.init):]).items()}
        return CohortHistory(
            seeds=list(seeds),
            accuracy=np.concatenate([acc0, r["accuracy"]], axis=1),
            T_k=np.concatenate([T0, r["T"]], axis=1),
            E_k=np.concatenate([E0, r["E"]], axis=1),
            selected=r["selected"].astype(np.int64), mask=r["mask"] > 0,
            with_init=True, num_devices=num_devices, cells=cells,
            inr=r.get("inr"), participation=r.get("participation"),
            staleness=r.get("staleness"), active=r.get("active"))
