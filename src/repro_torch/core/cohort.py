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
So does the port, by mesh position: over a ``("cohort",)`` mesh of
``min(cards, lane groups)`` positions the lane groups (a lane; a seed's
cells under a dynamic channel, which stay together) pad up to a multiple
of the positions with copies of the last group, and position ``i`` takes
the ``i``-th contiguous share. Each position's lanes are built on its
device and run as a program of their own (captured on that device), the
programs driven side by side with no host sync between
(``engine.run_programs``); there is no collective, as the lanes are
independent. Each position's history comes back in one transfer, the
histories join in lane order and the pad lanes are stripped. A mesh may
name one device more than once: the work goes by position.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import (RoundInputs, TracedRunResult,
                                     lane_view, run_programs, run_rounds)
from repro_torch.core.fedavg import (FLExperiment, FLHistory, history_parts,
                                     rounds_by_name, to_host)
from repro_torch.core.wireless import fleet_arrays
from repro_torch.launch.mesh import Mesh
from repro_torch.utils.spans import span

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


def cohort_mesh(cohort_size: int, device="cuda") -> Optional[Mesh]:
    """A 1-axis ``("cohort",)`` mesh over ``min(cards, cohort_size)`` of
    the cards this host sees, in order, or ``None`` where that is one (the
    CPU's one device, one card, one lane group: the lanes run on one
    device)."""
    dev = torch.device(device)
    n = min(torch.cuda.device_count() if dev.type == "cuda" else 1,
            cohort_size)
    if n <= 1:
        return None
    devices = np.empty(n, dtype=object)
    devices[:] = [torch.device("cuda", i) for i in range(n)]
    return Mesh(("cohort",), {"cohort": n}, devices)


def _mesh_pad(lanes: int, mesh) -> int:
    """How many pad lanes make ``lanes`` divide the mesh's device count."""
    if mesh is None:
        return 0
    return (-lanes) % mesh.devices.size


def _shard_cohort(groups, mesh):
    """The (padded) lane groups as one contiguous share a mesh position,
    in position order; on no mesh, ``groups`` itself (one device runs
    them all)."""
    if mesh is None:
        return groups
    m = mesh.devices.size
    per = len(groups) // m
    return [groups[i * per:(i + 1) * per] for i in range(m)]


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
    cells) as lanes of one device-resident program a mesh position
    (``cohort_mesh``; one position on a one-card host).

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
        self._pads: List[FLExperiment] = []   # the pad lanes' copies
        self.program = None             # the last run's TracedProgram
        self.programs = []              # one a mesh position

    @property
    def num_cells(self) -> int:
        return self.spec.num_cells

    def _build(self, lanes: Sequence[tuple],
               devices: Sequence[torch.device]) -> List[FLExperiment]:
        """One experiment a ``(seed, cell)`` lane, each on its device."""
        from repro_torch.api.build import build_experiment
        exps = [build_experiment(
                    self.spec.replace(seed=s), device=dev, cell=c,
                    draws=None if self.draws is None else self.draws(s))
                for (s, c), dev in zip(lanes, devices)]
        counts = {e.fed.num_clients for e in exps}
        if len(counts) > 1:
            raise ValueError(
                "CohortRunner stacks (seed, cell) lanes into one program; "
                f"all cells need equal device counts, got {counts}")
        return exps

    def _prog_cells(self) -> int:
        """Lanes a group: a seed's cells under a dynamic channel (its
        round couples them), else one."""
        fs = self.spec.fleet
        if fs is None:
            return 1
        from repro_torch.api.registry import CHANNELS
        dynamic = getattr(CHANNELS.resolve(fs.channel), "dynamic", False)
        return self.num_cells if dynamic else 1

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
        (``self.experiments``, each on its mesh position's device);
        ``self.program`` is the program the run replayed (one captured
        round for all lanes; over a ``cohort_mesh`` of several positions,
        ``self.programs`` holds one a position and ``self.program`` is
        position 0's)."""
        if seeds is None:
            seeds = [self.spec.seed + i
                     for i in range(max(int(self.spec.cohort), 1))]
        seeds = [int(s) for s in seeds]
        with span("fl.call", lanes=len(seeds) * self.num_cells,
                  rounds=rounds or self.spec.rounds):
            return self._run(seeds, rounds, reuse_experiments,
                             transfer_guard)

    def _run(self, seeds, rounds, reuse_experiments, transfer_guard):
        """:meth:`run`'s body, inside its ``fl.call`` span."""
        cells = self.num_cells
        lanes = [(s, c) for s in seeds for c in range(cells)]
        lane_seeds = [s for s, _ in lanes]
        rounds = rounds or self.spec.rounds
        # lane groups (a dynamic channel couples each seed's cells inside
        # the round), padded with copies of the last group up to a
        # multiple of the mesh's positions, one contiguous share each
        prog_cells = self._prog_cells()
        groups = [lanes[g:g + prog_cells]
                  for g in range(0, len(lanes), prog_cells)]
        mesh = cohort_mesh(len(groups), self.device)
        pad = _mesh_pad(len(groups), mesh)
        padded_groups = groups + [groups[-1]] * pad
        if mesh is None:
            devices, shares = [self.device], [padded_groups]
        else:
            devices = list(mesh.devices.flat)
            shares = _shard_cohort(padded_groups, mesh)
        where = [dev for dev, share in zip(devices, shares)
                 for group in share for _ in group]
        real, padded = where[:len(lanes)], where[len(lanes):]
        if not (reuse_experiments and len(self.experiments) == len(lanes)
                and [e.device for e in self.experiments] == real):
            self.experiments = self._build(lanes, real)
        if [e.device for e in self._pads] != padded:
            self._pads = self._build(lanes[-prog_cells:] * pad, padded)
        pads = self._pads
        exps = self.experiments + pads
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
        # one evaluation set for the whole cohort iff every seed resolves
        # the same test data (the sweeps' protocol), else one a lane
        shared = len({e.spec.resolved_test_seed for e in exps}) == 1
        runs, programs, at = [], [], 0
        for pos, (dev, share) in enumerate(zip(devices, shares)):
            own = exps[at:at + len(share) * prog_cells]
            at += len(own)
            with span("fl.stack", position=pos):
                state = type(e0.traced_state())(*(
                    _stack_lanes(parts)
                    for parts in zip(*(e.traced_state() for e in own))))
                ins = [e.traced_inputs() for e in own]
                inputs = RoundInputs(
                    images=_stack(x.images for x in ins),
                    labels=_stack(x.labels for x in ins),
                    sizes=_stack(x.sizes for x in ins),
                    arr=fleet_arrays([e.fleet for e in own], dev),
                    test_images=(ins[0].test_images if shared
                                 else _stack(x.test_images for x in ins)),
                    test_labels=(ins[0].test_labels if shared
                                 else _stack(x.test_labels for x in ins)))
            prog = run_rounds(
                e0.engine_cfg, selector=e0.selector, allocator=e0.allocator,
                aggregator=e0.aggregator, tctx=e0.traced_context(),
                feature_layer=e0.fl.feature_layer, device=dev,
                shapes=inputs.shapes(), base=own[0].base,
                compressor=e0.compressor, channel=e0.channel,
                cells=prog_cells, churn=e0.churn, position=pos)
            programs.append(prog)
            runs.append((prog, (state, *inputs),
                         dict(draws=[e.draws for e in own], rounds=rounds,
                              with_init=True)))
        self.programs = programs
        self.program = programs[0]
        results = run_programs(runs, transfer_guard=transfer_guard)
        # each position's history and K-means labels in one transfer,
        # joined in lane order, the pad lanes stripped
        n_init = len(results[0].init)
        with span("fl.history"):
            per = [to_host(history_parts(r) + [r.state.labels])
                   for r in results]
        joined = []
        for k, parts in enumerate(zip(*per)):
            # the initial round's values and the labels are [B, ...], a
            # round's [R, B, ...]
            axis = 1 if n_init <= k < len(per[0]) - 1 else 0
            whole = np.concatenate(parts, axis=axis)
            joined.append(whole[:len(lanes)] if axis == 0
                          else whole[:, :len(lanes)])
        *vals, lane_labels = joined
        views = [lane_view(r.state, b) for r in results
                 for b in range(r.state.params.shape[0])]
        with span("fl.unstack"):
            for i, e in enumerate(self.experiments):
                e.load_traced_state(views[i], labels=lane_labels[i])
        return self._history(lane_seeds, results[0], vals,
                             e0.fed.num_clients, cells)

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
