#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

from the root of a checkout. Phases, in order; any failure exits non-zero:

1. the card's name and power limit, then both hand-written kernels built
   from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each, together);
2. each kernel against its plain PyTorch version at the shapes the FL loop
   gives it, with the max error against the tolerance and the kernel's,
   the plain version's, one library call's and the bound's times
   (CUDA-event medians after warm-up, L2 flushed before every call);
3. a tiny experiment run on the CPU and on the card from the same draws,
   which must agree (selections, T_k, E_k, the global row);
4. the main path: ``build_experiment(ExperimentSpec())`` — the paper's
   MNIST CNN at full width (P = 113,744), N = 40, S = 10, L = 20 — for the
   initial round and 3 rounds, with every kernel's launch count read from
   this run alone;
5. where one more round's time goes (host clock, ``torch.profiler``);
6. a ``kernels`` JSON line, then ``{"ok": true, "device": {...}}`` last.

It exits non-zero and prints no result when there is no CUDA card or when
the port's sources are missing.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
AGG_TOL = dict(rtol=2e-5, atol=2e-5)
L2_TOL = dict(rtol=1e-4, atol=1e-3)
P_MNIST = 113_744
DEVICE = "cuda"


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


class Timer:
    """Per-call device time: CUDA events around one call, with a 256 MB
    write before each call so it finds L2 (50 MB) cold, as the round does
    after training; the median over ``reps`` calls after ``warm`` calls.
    The flush keeps the device busy while the host enqueues the call, so
    the events time the call's own device work."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device=DEVICE)

    def __call__(self, fn, reps=30, warm=3):
        torch = self.torch
        for _ in range(warm):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def least_band_mhz(fleet):
    """Per device, the least band [MHz] that meets its energy budget
    (19a) at its slowest clock f_min: Q(b) = b·log2(1 + J/b) must reach
    H / (e_cons − G·f_min²). Float64 bisection on the host (Q rises in b,
    Lemma 2), apart from the solver; inf where no band is enough. Problem
    (19) is feasible at B exactly when a set's sum is at most B, and an
    infeasible set's SAO answer gives each device this least band."""
    import numpy as np
    J = fleet.J_mhz() / (1.0 + fleet.inr)
    resid = fleet.e_cons - fleet.G_joule_per_ghz2() * fleet.f_min ** 2
    with np.errstate(divide="ignore"):
        need = np.where(resid > 0, fleet.H_joule() / resid, np.inf)
    lo, hi = np.zeros_like(J), np.full_like(J, 1e9)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        ge = mid * np.log2(1.0 + J / mid) >= need
        lo, hi = np.where(ge, lo, mid), np.where(ge, mid, hi)
    return np.where(need < J / math.log(2.0), hi, np.inf)


def kernel_phase(torch, timer):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flat_aggregate import (flat_aggregate,
                                                    flat_aggregate_plain)
    from repro_torch.kernels.pairwise_l2 import pairwise_l2

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = {}

    for n in (10, 40, 100):
        flat = torch.randn((n, P_MNIST), generator=gen, device=DEVICE)
        w = torch.rand((n,), generator=gen, device=DEVICE) + 0.1
        flat[n // 2] = float("nan")              # a NaN row at weight 0
        w[n // 2] = 0.0
        w = w / w.sum()
        got, want = flat_aggregate(flat, w), flat_aggregate_plain(flat, w)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"flat_aggregate [{n},{P_MNIST}]: non-finite output")
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, **AGG_TOL)
        live = int((w > 0).sum())                 # rows the kernel reads
        b_ms, b_by = bound(live * P_MNIST * 4 + n * 4 + P_MNIST * 4,
                           2 * live * P_MNIST)
        flat_lib = torch.where(w[:, None] > 0, flat,
                               torch.zeros((), device=DEVICE))
        r = dict(shape=[n, P_MNIST], max_abs_err=err, ok=bool(ok),
                 ms=timer(lambda: flat_aggregate(flat, w)),
                 plain_ms=timer(lambda: flat_aggregate_plain(flat, w)),
                 library_ms=timer(lambda: torch.mv(flat_lib.t(), w)),
                 bound_ms=b_ms, bound_by=b_by)
        print(f"  flat_aggregate [{n},{P_MNIST}] max_abs_err={err:.3e} "
              f"(tol rtol/atol 2e-5: {'ok' if ok else 'FAIL'}) "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms(torch.mv)={r['library_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})")
        check(ok, f"flat_aggregate [{n},{P_MNIST}] disagrees with its "
                  f"plain version: max_abs_err={err}")
        rows.setdefault("flat_aggregate", []).append(r)
        del flat, flat_lib

    for n, m, f in ((40, 10, 2240), (40, 1, P_MNIST)):
        x = torch.randn((n, f), generator=gen, device=DEVICE)
        c = torch.randn((m, f), generator=gen, device=DEVICE)
        got, want = pairwise_l2(x, c), ref.pairwise_l2_ref(x, c)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, **L2_TOL)
        b_ms, b_by = bound((n * f + m * f + n * m) * 4, 3 * n * m * f)
        r = dict(shape=[n, m, f], max_abs_err=err, ok=bool(ok),
                 ms=timer(lambda: pairwise_l2(x, c)),
                 plain_ms=timer(lambda: ref.pairwise_l2_ref(x, c)),
                 library_ms=timer(lambda: torch.cdist(x, c).square()),
                 bound_ms=b_ms, bound_by=b_by)
        print(f"  pairwise_l2 [{n},{f}]x[{m},{f}] max_abs_err={err:.3e} "
              f"(tol rtol 1e-4 atol 1e-3: {'ok' if ok else 'FAIL'}) "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms(cdist^2)={r['library_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})")
        check(ok, f"pairwise_l2 [{n},{f}]x[{m},{f}] disagrees with its "
                  f"plain version: max_abs_err={err}")
        rows.setdefault("pairwise_l2", []).append(r)
    return rows


class _CpuDraws:
    """The default draws made on the CPU and moved to ``device``, so one
    seed gives the same numbers to a CPU run and a card run."""

    def __init__(self, seed, device):
        from repro_torch.core.draws import TorchDraws
        self.inner = TorchDraws(seed, "cpu")
        self.device = device

    def init_params(self, model_cfg):
        return {k: v.to(self.device)
                for k, v in self.inner.init_params(model_cfg).items()}

    def batch_indices(self, *args):
        return self.inner.batch_indices(*args).to(self.device)

    def kmeans_seed(self, n, c):
        return self.inner.kmeans_seed(n, c).to(self.device)

    def kmeans_choice(self, i, p):
        return self.inner.kmeans_choice(i, p.cpu()).to(self.device)


def agreement_phase(torch):
    """A tiny experiment on the CPU (plain paths) and on the card (the
    kernels), from the same draws: the card run must agree."""
    from repro_torch.api import ExperimentSpec, build_experiment
    spec = ExperimentSpec(dataset="fashion", clients=8, samples_per_client=16,
                          train_samples=160, test_samples=80, local_iters=2,
                          batch_size=8, devices_per_round=4, num_clusters=4,
                          rounds=2)
    out = {}
    for dev in ("cpu", DEVICE):
        exp = build_experiment(spec, device=dev, draws=_CpuDraws(0, dev))
        out[dev] = (exp.run(), exp.global_vec.cpu())
    (h_cpu, g_cpu), (h_gpu, g_gpu) = out["cpu"], out[DEVICE]
    for k, (a, b) in enumerate(zip(h_cpu.selected, h_gpu.selected)):
        check(list(a) == list(b), f"agreement: round {k} selected {list(b)} "
                                  f"on the card, {list(a)} on the CPU")
    for name in ("T_k", "E_k"):
        a, b = getattr(h_cpu, name), getattr(h_gpu, name)
        check(all(math.isclose(x, y, rel_tol=2e-3) for x, y in zip(a, b)),
              f"agreement: {name} {b} on the card, {a} on the CPU")
    err = float((g_cpu - g_gpu).abs().max())
    print(f"  tiny fashion run, CPU vs card: selections equal, T_k/E_k "
          f"within rtol 2e-3, global row max_abs_err={err:.3e} (tol 1e-4)")
    check(err <= 1e-4, f"agreement: global row differs by {err}")


def main_path_phase(torch, spec):
    """``spec`` on the card for the initial round and 3 rounds; the launch
    counts are read from this run alone."""
    from repro_torch.api import build_experiment
    from repro_torch.core.sao import solve_sao
    from repro_torch.core.wireless import fleet_arrays
    from repro_torch.kernels.flat_aggregate import flat_aggregate
    from repro_torch.kernels.pairwise_l2 import pairwise_l2

    t0 = time.perf_counter()
    exp = build_experiment(spec, device=DEVICE)
    torch.cuda.synchronize()
    print(f"  build_experiment({spec.dataset} spec) on {exp.device}: "
          f"{time.perf_counter() - t0:.2f} s; P={exp.global_vec.numel()}, "
          f"N={spec.clients}, S={spec.devices_per_round}, "
          f"L={spec.local_iters}")
    flat_aggregate.launches = 0
    pairwise_l2.launches = 0
    hist = exp.run(rounds=3)
    torch.cuda.synchronize()
    launches = {"flat_aggregate": flat_aggregate.launches,
                "pairwise_l2": pairwise_l2.launches}
    for k in range(len(hist.accuracy)):
        print(f"  round {k}: accuracy={hist.accuracy[k]:.4f} "
              f"T_k={hist.T_k[k]:.6f} s E_k={hist.E_k[k]:.6f} J "
              f"band={hist.band_mhz[k]:.4f} MHz "
              f"selected={list(map(int, hist.selected[k]))} "
              f"wall={hist.seconds[k]:.3f} s")
    print(f"  launches in this run: {launches}")
    vals = hist.accuracy + hist.T_k + hist.E_k + hist.band_mhz
    check(all(math.isfinite(v) for v in vals), "non-finite history value")
    check(all(0.0 <= a <= 1.0 for a in hist.accuracy), "accuracy outside "
                                                       "[0, 1]")
    check(bool(torch.isfinite(exp.global_vec).all()), "non-finite global row")
    check(len(hist.accuracy) == 4, "expected the initial round + 3 rounds")
    # (19c): where problem (19) is feasible the solve keeps Σb within B.
    # Where the set's least band (energy budgets met at f_min, computed
    # apart from the solver) exceeds B, no allocation fits: SAO must flag
    # it (converged=False, as the reference's solver does) and give each
    # device its least band. Within 1e-3 of B either answer is accepted.
    B = spec.bandwidth_mhz
    need = least_band_mhz(exp.fleet)
    for k, (sel, band) in enumerate(zip(hist.selected, hist.band_mhz)):
        sol = solve_sao(fleet_arrays(exp.fleet.select(sel), exp.device), B)
        converged = bool(sol.converged)
        least = float(need[sel].sum())
        check(math.isclose(float(sol.b.sum()), band, rel_tol=1e-6),
              f"round {k}: the SAO re-solve differs from the run")
        if converged:
            check(band <= B * (1 + 1e-4), f"round {k}: SAO converged but "
                                          f"uses {band} MHz of {B}")
        else:
            check(math.isclose(band, least, rel_tol=1e-4),
                  f"round {k}: flagged, but Σb={band} MHz is not the least "
                  f"band {least} MHz")
        if least <= B * (1 - 1e-3) or least > B:
            check(converged == (least <= B),
                  f"round {k}: converged={converged}, but the least band "
                  f"is {least} MHz of B={B}")
        print(f"  round {k}: Σb={band:.4f} MHz of B={B}, least band "
              f"{least:.4f} MHz ("
              f"{'within B' if converged else 'set infeasible at B: flagged'}"
              f")")
    for sel in hist.selected[1:]:
        check(0 < len(sel) <= spec.devices_per_round
              and len(set(map(int, sel))) == len(sel)
              and all(0 <= int(i) < spec.clients for i in sel),
              f"bad selection {sel}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    return exp, launches


def profile_phase(torch, exp, reps=3):
    """Where one round's time goes. First ``reps`` rounds driven through
    the experiment's own pieces, host clock with a device sync at the end
    of each phase (no profiler): select (divergence + Alg. 4), allocate
    (SAO), train, aggregate (eq. 4), evaluate. Then one ``exp.round()``
    under ``torch.profiler``: its device work by kernel, the busy total and
    the device's idle share against the unprofiled round wall."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    laps = defaultdict(list)

    def lap(name, t0):
        torch.cuda.synchronize()
        t = time.perf_counter()
        laps[name].append(t - t0)
        return t

    for _ in range(reps):
        t0 = start = time.perf_counter()
        idx = exp.select()
        t0 = lap("select", t0)
        float(exp.allocation(idx).T)
        t0 = lap("allocate", t0)
        rows = exp.train_clients(idx)
        t0 = lap("train", t0)
        exp.store_clients(rows, idx)
        exp.aggregate(rows, idx)
        t0 = lap("aggregate", t0)
        exp.evaluate()
        lap("evaluate", t0)
        laps["round"].append(time.perf_counter() - start)
    ms = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in laps.items()}
    print(f"  round wall, median of {reps} (no profiler): "
          f"{ms['round']:.1f} ms = " + ", ".join(
              f"{k} {ms[k]:.1f}" for k in ("select", "allocate", "train",
                                           "aggregate", "evaluate")))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exp.round()
        torch.cuda.synchronize()
    kinds, by_name = defaultdict(int), defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = getattr(e, "activity_type", None)
        kinds[kind] += 1
        # the device timeline also carries annotations (spans, aten ops):
        # only kernels, copies and memsets are device work
        if (e.is_user_annotation or e.name.startswith(("aten::", "fl."))
                or kind not in (None, "kernel", "gpu_memcpy", "gpu_memset")):
            continue
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    launches = sum(n for n, _ in by_name.values())
    busy = sum(t for _, t in by_name.values())
    print(f"  one profiled round: {launches} device launches, {busy:.2f} ms "
          f"busy; idle share vs the unprofiled wall "
          f"{1 - busy / ms['round']:.4f} (device event kinds {dict(kinds)})")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"  kernel {name[:72]}: {n} launches, {t:.3f} ms")
    return ms


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    print("== 1. card and build")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    names = ["flat_aggregate", "pairwise_l2"]
    t0 = time.perf_counter()
    logs = build.build(names, ptxas_verbose=True)
    print(f"  built {names} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("== 2. kernels against their plain versions")
    timer = Timer(torch)
    rows = kernel_phase(torch, timer)
    del timer
    torch.cuda.empty_cache()

    print("== 3. CPU and card agree on a tiny run")
    agreement_phase(torch)

    print("== 4. main path: ExperimentSpec() on the card, 3 rounds")
    from repro_torch.api import ExperimentSpec
    exp, launches = main_path_phase(torch, ExperimentSpec())

    print("== 5. where one round's time goes")
    profile_phase(torch, exp)

    source = {"flat_aggregate": "src/repro_torch/kernels/csrc/"
                                "flat_aggregate.cu",
              "pairwise_l2": "src/repro_torch/kernels/csrc/pairwise_l2.cu"}
    replaces = {"flat_aggregate": "src/repro/kernels/flat_aggregate.py:38",
                "pairwise_l2": "src/repro/kernels/pairwise_l2.py:45"}
    kernels = []
    for name, per_shape in rows.items():
        top = per_shape[0]     # the shape the main path launches most often
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "shape": top["shape"],
            "at_shapes": per_shape})
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
