"""What every cell shares: the files found by name, the measured window,
the device trace between marks, the result line and its checks.

A cell's driver (``drivers/<entry>.py``) gives ``setup(ctx) -> cell``;
the cell's ``call()`` runs one timed call of the port's entry point and
returns a :class:`Call`; ``release()`` frees the program's state after the
window; ``check()`` runs the plain reference over a sample of what the
window produced and returns :class:`Check` s. The harness times the
window, traces it (``--trace 1``), reads the metrics through the readers
in ``metrics/<name>.py`` and prints the result.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# device work the profiler records (kernels, copies, memsets)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# marker bursts around a traced window: the profiler drops the device
# records of a session's first moments, so what it drops must be marks
MARK_BURSTS, MARK_SPINS, MARK_GAP_S = 40, 16, 0.005


@dataclasses.dataclass
class Call:
    """One timed call: the rounds it replayed (``rounds``), those times
    the lanes (``seed_rounds``), and a latency a round where each round
    ends on the host (``latencies_ms``)."""
    rounds: int
    seed_rounds: int
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    seconds: float = 0.0


@dataclasses.dataclass
class Check:
    """One number compared with its limit (``value <= limit`` passes)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock: its age from
    ``/proc/self/stat`` (field 22, clock ticks after boot) against the
    boot clock; the import of this module where that cannot be read."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def set_cache_dirs() -> None:
    """Every build and kernel cache a run may write, at fixed paths inside
    the checkout (``build/`` is ignored by git). The port's own kernels
    build into ``build/kernels`` (``repro_torch.kernels.build``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, as a module."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those whose ``workloads`` list it; without that key,
    an end-to-end metric in every cell and a per-layer one wherever the
    end-to-end metric it moves is reported."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def check_rng(seed: int):
    """The numpy stream of a run's samples of what to check: its own,
    apart from every input drawn from the seed."""
    import numpy as np
    return np.random.default_rng([0x5EED, int(seed)])


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's, Flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------


def mark(torch, bursts: int = MARK_BURSTS) -> None:
    """Marker device work: ``bursts`` bursts of ``MARK_SPINS`` short spin
    kernels, each burst synced and followed by ``MARK_GAP_S`` of host
    sleep (about 0.2 s in all)."""
    for _ in range(bursts):
        for _ in range(MARK_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(MARK_GAP_S)


def device_work(prof) -> list:
    """A CUDA-activity profile's device work (kernels, copies, memsets; a
    replayed graph gives each of its kernels) as ``(start_ns, end_ns,
    name)``; annotations on the device timeline are not work."""
    from torch.autograd import DeviceType
    work = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        note = e.is_user_annotation() if hasattr(
            e, "is_user_annotation") else False
        name = e.name()
        if note or name.startswith(("aten::", "fl.")) or kind not in (
                None, *DEVICE_WORK):
            continue
        start = e.start_ns()
        work.append((start, start + e.duration_ns(), name))
    return work


@dataclasses.dataclass
class Trace:
    """The device records of a traced window (the marks removed), the
    marks kept on each side, and the window's host wall [s]."""
    records: list
    marks_before: int
    marks_after: int
    window_s: float

    def busy_s(self) -> float:
        """The union of the records' intervals [s]."""
        total, end = 0, None
        for s, e, _ in sorted(self.records):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def time_of(self, match: Callable[[str], bool]) -> float:
        """Summed device time [s] of the records whose name matches."""
        return sum(e - s for s, e, n in self.records if match(n)) / 1e9

    def count(self, match: Callable[[str], bool] = lambda n: True) -> int:
        return sum(1 for _, _, n in self.records if match(n))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps between consecutive records, each named by the records on its
        two sides."""
        by_name: Dict[str, int] = {}
        for s, e, n in self.records:
            by_name[n] = by_name.get(n, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end, prev = [], None, None
        for s, e, n in sorted(self.records):
            if end is not None and s > end:
                gaps.append((f"{prev[:60]} -> {n[:60]}", s - end))
            if end is None or e > end:
                end, prev = e, n
        gaps = sorted(gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[n, t / 1e9] for n, t in gaps]}


def traced(torch, fn):
    """``fn()`` under ``torch.profiler`` (device activity only) between
    two runs of :func:`mark`; returns ``(fn's result, Trace)``. Raises
    when the profiler kept no marks on one side: its window may have cut
    the call's own records."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mark(torch)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        mark(torch)
    events = device_work(prof)
    marks = [s for s, _, n in events if "spin_kernel" in n]
    work = [w for w in events if "spin_kernel" not in w[2]]
    if not work:
        raise RuntimeError("the profiler recorded no device work in the "
                           "traced window")
    first = min(s for s, _, _ in work)
    last = max(s for s, _, _ in work)
    before = sum(t < first for t in marks)
    after = sum(t > last for t in marks)
    if not (before and after):
        raise RuntimeError(
            f"the profiler kept {before} marks before the traced window and "
            f"{after} after it (of {MARK_BURSTS * MARK_SPINS} each): its "
            "window may have cut the traced calls' records")
    return out, Trace(work, before, after, window)


# ---------------------------------------------------------------------------
# one run of one cell
# ---------------------------------------------------------------------------


def device_info(torch, chips: int, device: str) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def run_cell(name: str, workload: dict, config: dict, traffic: dict,
             bench: dict, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: Optional[float] = None,
             log=print) -> dict:
    """One run of cell ``name``: set-up, the window, with ``trace`` then
    ``trace_calls`` calls (the workload's, default 1) under the profiler,
    the metrics, then the reference's checks over every call. Returns the
    result's fields; ``checks`` is the list of :class:`Check` s."""
    import torch

    started = process_start() if started is None else started
    driver = load_module("drivers", workload["entry"])
    ctx = SimpleNamespace(name=name, workload=workload, config=config,
                          traffic=traffic, seed=int(seed), device=device,
                          chips=int(workload["chips"]), log=log)
    cell = driver.setup(ctx)
    calls: List[Call] = []
    tr = None

    def window(limit_calls=None):
        t_first = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            calls.append(cell.call())
            now = time.perf_counter()
            calls[-1].seconds = now - t0
            if now - t_first >= seconds or (limit_calls is not None
                                            and len(calls) >= limit_calls):
                return now - t_first

    setup_s = time.perf_counter() - started
    window_s = window()
    timed = list(calls)
    if trace:
        # the profiler slows the host's launches: the window's time stays
        # the untraced one, and ``trace_calls`` more calls are traced
        _, tr = traced(torch, lambda: window(
            len(calls) + workload.get("trace_calls", 1)))
    dev = device_info(torch, ctx.chips, device)
    log("portbench: the window's calls [s]: "
        + " ".join(f"{c.seconds:.4f}" for c in timed)
        + ("; traced: " + " ".join(f"{c.seconds:.4f}"
                                   for c in calls[len(timed):])
           if trace else ""))
    run = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, calls=timed,
        rounds=sum(c.rounds for c in timed),
        seed_rounds=sum(c.seed_rounds for c in timed),
        latencies_ms=[x for c in timed for x in c.latencies_ms],
        traced_rounds=sum(c.rounds for c in calls[len(timed):]),
        traced_seed_rounds=sum(c.seed_rounds for c in calls[len(timed):]),
        trace=tr, cell=cell, config=config, traffic=traffic, device=dev)
    if trace and hasattr(cell, "measure_layers"):
        cell.measure_layers()
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, name, section):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cell.release()
    checks = cell.check()
    out = {"correct": all(c.ok for c in checks),
           "attempted": sum(c.seed_rounds for c in calls), "failed": 0,
           "metrics": metrics,
           "device": dev, "checks": checks}
    if tr is not None:
        out["device"] = dict(dev, busy_s=tr.busy_s(), window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    return out


def result_line(out: dict) -> str:
    """The result as one JSON line, the checks last: each compared number
    beside its limit."""
    line = {k: v for k, v in out.items() if k != "checks"}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out["checks"]}
    return json.dumps(line)


def check_lines(checks: List[Check]) -> List[str]:
    return [f"check {c.name} = {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'FAILED'}" for c in checks]
