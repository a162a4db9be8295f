#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit); the last lines of standard error repeat the
checks. With ``--trace 0`` the metrics are the cell's end-to-end metrics
of ``BENCHMARK.json``, with ``--trace 1`` its per-layer metrics. Exits
non-zero, printing no result, without the cards the cell asks for, when
a module of JAX or of the JAX package was loaded, or on any error.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness
    started = harness.process_start()
    harness.set_cache_dirs()

    bench = harness.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no cell {args.workload!r} in BENCHMARK.json "
              f"(cells: {sorted(cells)})", file=sys.stderr)
        return 2
    workload = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", workload["config"])
    traffic = harness.load_json("traffic", workload["traffic"])

    import torch
    # one process, few threads: the host's cores are shared, and spinning
    # worker threads take them from the thread that launches the work
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    out = harness.run_cell(args.workload, workload, config, traffic, bench,
                           seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), started=started,
                           log=lambda *a: print(*a, file=sys.stderr,
                                                flush=True))
    found = harness.forbidden_modules()
    if found:
        print("portbench: modules of JAX or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    for line in harness.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
