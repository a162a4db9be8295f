#!/usr/bin/env python3
"""The readings a cell's limits are set from: whole runs of the cell on
many seeds in one process, each run's checks one JSON line.

    python3 portbench/readings.py --workload <cell> --seeds 12 \
        --first <seed> --seconds 3 [--control | --fault <name>]

``--control`` puts the cell's control in the program's place: for the CNN
cell the reference's local SGD in TF32 in place of the program's rows
(the port has no TF32 path of its own: it turns TF32 off), for the LM
round the plain round on fp8 (e4m3) clients
(``reference.fl_round.lower_round``). The
check is the run's own. Sound runs give the lower readings, the control
the upper ones (PERF.md gives both beside each limit); ``--fault``
plants one of ``portbench/faults.py``'s faults in the program."""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def tf32_rows() -> None:
    """The CNN cell's control: the rows the local-SGD comparison reads
    are the reference's own in TF32."""
    from portbench import flcnn
    flcnn.CONTROL["rows"] = "tf32"


def fp8_round() -> None:
    """The LM round's control: the reference's round on fp8 clients."""
    from repro_torch.launch import fl_round
    from portbench.reference.fl_round import lower_round

    def lower(clients, glob, cent, sizes, *, num_clusters, feature_slice=0):
        return lower_round(clients, glob, cent, sizes, num_clusters)
    fl_round.fl_round_step = lower


CONTROLS = {"fl_cohort": tf32_rows, "fl_round": fp8_round}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness
    harness.set_cache_dirs()
    import torch

    bench = harness.benchmark()
    wl = harness.load_json("workloads", args.workload)
    cfg = harness.load_json("configs", wl["config"])
    tr = harness.load_json("traffic", wl["traffic"])
    if args.control:
        CONTROLS[wl["entry"]]()
    if args.fault:
        from portbench import faults
        faults.FAULTS[wl["entry"]][args.fault](setattr)
    for seed in range(args.first, args.first + args.seeds):
        out = harness.run_cell(args.workload, wl, cfg, tr, bench, seed=seed,
                               seconds=args.seconds, trace=False,
                               log=lambda *a: print(*a, file=sys.stderr))
        print(json.dumps({"seed": seed, "control": args.control,
                          "fault": args.fault,
                          "correct": out["correct"],
                          "checks": {c.name: c.value for c in out["checks"]},
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()}}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
