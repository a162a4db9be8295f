"""The CNN cells' side of the harness: the spec a configuration gives,
the reference's lanes remade from the seeds, the solve timed for
``sao_solve_ms``, and the comparison of a call's history with the
reference's rounds."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from portbench.cost import cnn as cnn_cost
from portbench.harness import Check
from portbench.reference import data as ref_data
from portbench.reference import fl_cnn

SPEC_KEYS = ("dataset", "clients", "devices_per_round", "num_clusters",
             "selected_per_cluster", "local_iters", "batch_size", "sigma",
             "learning_rate", "samples_per_client", "train_samples",
             "test_samples", "bandwidth_mhz", "selection", "allocator",
             "aggregator", "store")

def spec_of(config: dict, traffic: dict, seed: int):
    from repro_torch.api import ExperimentSpec
    fl = config["fl"]
    return ExperimentSpec(seed=seed, rounds=traffic["rounds_per_call"],
                          **{k: fl[k] for k in SPEC_KEYS})


def layout_of(config: dict) -> fl_cnn.Layout:
    return fl_cnn.Layout(cnn_cost.shapes(config["model"]))


def reference_lane(config: dict, seed: int, device) -> fl_cnn.Lane:
    """The reference's lane of seed ``seed``: the data from the seed, the
    test set from seed + 10000, the partition from seed + 1 and the fleet
    from the seed (the spec's seed rules); its ``key`` is the seed."""
    m, fl = config["model"], config["fl"]
    hw, ch, k = m["input_hw"], m["input_channels"], m["num_classes"]
    x, y = ref_data.make_dataset(fl["dataset"], hw, ch, k,
                                 fl["train_samples"], seed)
    tx, ty = ref_data.make_dataset(fl["dataset"], hw, ch, k,
                                   fl["test_samples"], seed + 10_000)
    images, labels, sizes = ref_data.partition_bias(
        x, y, k, fl["clients"], fl["samples_per_client"], fl["sigma"],
        seed + 1)
    lane = fl_cnn.Lane(layout_of(config), fl, m["pool"], images, labels,
                       sizes, tx, ty, ref_data.fleet(fl["clients"], seed),
                       device)
    lane.key = seed
    return lane


def _worst(a: float, b: float) -> float:
    """The larger gap, a NaN (a number that never came) the worst."""
    return float("nan") if (a != a or b != b) else max(a, b)


@dataclasses.dataclass
class Gaps:
    """The largest gaps seen between the program and the reference. The
    local-SGD rows' gaps to their updates (``sgd``: by the lane's key and
    the stage) give two numbers: their median, which a precision below the
    configuration's moves in every row, and the worst row, which a fault
    in a few rows (one lane's) moves."""
    kmeans: float = 0.0
    selection: float = 0.0
    sgd: Dict[int, List[float]] = dataclasses.field(default_factory=dict)
    fold: float = 0.0
    T: float = 0.0
    E: float = 0.0
    acc: float = 0.0

    def allocation(self, T, E, ref_T, ref_E):
        self.T = _worst(self.T, abs(T - ref_T) / ref_T)
        self.E = _worst(self.E, abs(E - ref_E) / ref_E)

    def accuracy(self, acc, ref_acc):
        """``ref_acc``: the reference's ``(low, high)``; the gap is how
        far ``acc`` lies outside it."""
        low, high = ref_acc
        self.acc = _worst(self.acc, max(0.0, low - acc, acc - high))

    def lane_worst(self) -> List[tuple]:
        """Each lane's and stage's rows compared and worst row gaps (to
        the update, to the row)."""
        return [(*k, len(v), max(u for u, _ in v), max(r for _, r in v))
                for k, v in sorted(self.sgd.items())]

    def rows(self) -> int:
        return sum(len(v) for v in self.sgd.values())

    def checks(self, limits: dict) -> List[Check]:
        rows = [u for k in sorted(self.sgd) for u, _ in self.sgd[k]]
        nan = float("nan")
        names = [("kmeans_gap", self.kmeans), ("sel_gap", self.selection),
                 ("sgd_gap", float(np.median(rows)) if rows else nan),
                 ("sgd_row_gap", max(rows) if rows else nan),
                 ("fold_gap", self.fold),
                 ("T_gap", self.T), ("E_gap", self.E), ("acc_gap", self.acc)]
        return [Check(n, float(v), float(limits[n])) for n, v in names]


#: the control in the program's place: ``"tf32"`` makes the rows the
#: local-SGD comparison reads the reference's own, computed in TF32
CONTROL = {"rows": None}


def _rows(lane, g, clients, batch):
    if CONTROL["rows"] == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            return lane.train(g, clients, batch)
        finally:
            tf32_off()
    return None


def _row_gaps(gaps: Gaps, lane, stage, g, clients, batch, got, ref=None):
    """Each client's row after local SGD from ``g`` (``ref``: the
    reference's rows, else trained here) against ``got``: the gap relative
    to the client's update, ‖got − ref‖ / ‖ref − g‖, and (for the log)
    to the row, ‖got − ref‖ / ‖ref‖, kept under the lane's key and
    ``stage`` (``"init"``: the initial round's, ``"round"``: a replayed
    round's)."""
    if not len(clients):
        return
    ref = lane.train(g, clients, batch) if ref is None else ref
    lower = _rows(lane, g, clients, batch)
    got = got if lower is None else lower
    row_gaps = gaps.sgd.setdefault((lane.key, stage), [])
    for r, x in zip(ref.double(), got.double()):
        d = float((x - r).norm())
        row_gaps.append((d / float((r - g.double()).norm()),
                         d / float(r.norm())))


def check_call(lane: fl_cnn.Lane, gaps: Gaps, labels, g0, init, rounds,
               batches, g_end, plane_end, allocate=True):
    """A call against the reference from what is known exactly: its
    start ``g0``; its initial round from ``g0`` (``init``: ``(batch0,
    (acc, T, E))``): its labels as a K-means fixed point, the rows no
    round overwrote (its accuracy is of a row the reference cannot take
    from the program, and is not compared); its ``rounds``' selections
    (``(selected, acc, T, E)`` a round) and its end ``g_end``,
    ``plane_end``. A round's start row is known where the previous
    round's rows all reach the end unchanged (the fold of them); each
    client whose row a round left to the end is trained again from that
    start and compared; round 1's selection is Alg. 4's on the start; the
    end row is the fold of the last round's rows; each known round's row
    has its accuracy; with ``allocate``, SAO runs on each round's
    selection and the initial round's devices."""
    sels = [np.asarray(r[0], np.int64) for r in rounds]
    later = [set(np.concatenate(sels[j + 1:]).tolist()) if j + 1 < len(sels)
             else set() for j in range(len(sels))]
    touched = set(np.concatenate(sels).tolist())
    batch0, (_, T, E) = init
    plane, g, r_T, r_E = lane.initial_round(g0, batch0, allocate=allocate)
    if allocate:
        gaps.allocation(T, E, r_T, r_E)
    gaps.kmeans = max(gaps.kmeans, fl_cnn.kmeans_gap(
        plane[:, lane.layout.columns("w_fc2")], labels))
    kept = np.array([i for i in range(plane.shape[0]) if i not in touched],
                    np.int64)
    at = torch.as_tensor(kept, device=plane.device)
    _row_gaps(gaps, lane, "init", g0, kept, batch0[at], plane_end[at],
              ref=plane[at])
    gaps.selection = max(gaps.selection,
                         lane.selection_gap(g, plane, labels, sels[0]))
    live = lane.live_lanes(labels)
    n_lanes = lane.fl["num_clusters"] * lane.fl["selected_per_cluster"]
    for j, (sel, (_, acc, T, E)) in enumerate(zip(sels, rounds)):
        if allocate:
            gaps.allocation(T, E, *lane.allocate(sel, n_lanes))
        if g is not None and len(sel) == len(live):
            keep = [t for t, c in enumerate(sel) if c not in later[j]]
            rows = torch.as_tensor(live[keep], device=batches[j].device)
            _row_gaps(gaps, lane, "round", g, sel[keep], batches[j][rows],
                      plane_end[torch.as_tensor(sel[keep],
                                                device=plane_end.device)])
        at = torch.as_tensor(sel, device=plane_end.device)
        g = (lane.fold(plane_end[at], sel) if not set(sel.tolist())
             & later[j] else None)
        if g is not None:
            gaps.accuracy(acc, lane.accuracy(g))
    end = lane.fold(plane_end[torch.as_tensor(sels[-1],
                                              device=plane_end.device)],
                    sels[-1])
    gaps.fold = max(gaps.fold, float((g_end.double() - end.double()).norm()
                                     / end.double().norm()))


def time_solve(arr: Dict[str, torch.Tensor], B: float, mask, reps: int = 10):
    """``solve_sao`` alone on ``arr`` [ms a call], CUDA events around
    ``reps`` calls after two (the second captures its graph)."""
    from repro_torch.core.sao import solve_sao
    for _ in range(2):
        solve_sao(arr, B, mask=mask)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        solve_sao(arr, B, mask=mask)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def least_seed_round_s(config: dict) -> float:
    from portbench.peaks import least_s
    flops, nbytes = cnn_cost.seed_round(config)
    return least_s(flops, nbytes, config["precision"])


def tf32_off() -> None:
    """The configuration's float32: no TF32 in products (the port's own
    setting, made here too before the reference runs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
