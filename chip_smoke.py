#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

from the root of a checkout. Phases, in order; any failure exits non-zero:

1. the card's name and power limit, then the four hand-written kernels
   built from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each,
   together);
2. each kernel against its plain PyTorch version at the shapes the FL and
   LM paths give it, with the max error against the tolerance, the
   kernel's, the plain version's, one library call's and the bound's times
   (CUDA-event medians after warm-up, L2 flushed before every call) and
   the device launches one call makes; then ``ssd_scan``'s forward plus
   backward against autograd through its plain version; (d) the lane
   forms of ``flat_aggregate`` and ``pairwise_l2`` at the cohort's shapes;
   a divergence (one centroid) runs on its plan of P alone, at the dense
   plane's, the paged store's chunk, base-row and 1000-row shapes; and the
   asynchronous tick's: the fold of its M = 4 candidates ([4, 113744],
   and [2, 4, 113744] in a cohort of 2) and their divergence; and the
   remaining families' attention and SSD shapes (granite's H/K = 3,
   seamless's non-causal encoder, jamba's P = 32, N = 16);
3. tiny experiments (the fashion CNN, and the tinyllama and mamba2 smoke
   LMs) run on the CPU and on the card from the same draws, which must
   agree (selections, T_k, E_k, the global row); ``run()`` takes the
   device-resident path on both (on the card: a captured round);
4. the main path: ``build_experiment(ExperimentSpec())`` — the paper's
   MNIST CNN at full width (P = 113,744), N = 40, S = 10, L = 20 — for the
   initial round and 3 rounds of the host loop, with every kernel's launch
   count read from this run alone;
5. where one more round's time goes (host clock, ``torch.profiler``);
6. the federated LM at full width: LoRA adapters over tinyllama-1.1b and
   over mamba2-130m (published widths and depths, random base from a
   seed), N = 10, S = 4, c = 4, L = 2, batch 8, 32-token windows, for the
   initial round and 2 rounds each, with the launch counts read from each
   run alone, then one more round broken down as in phase 5;
7. the paper's comparisons: (a) Fig. 5 — SAO, SAO with the box
   correction, equal bandwidth and FEDL (tuned λ, 4.58, 1000, and tuned
   every call) on 10 devices, each against the CPU, and SAO's and FEDL's
   CUDA graphs against their eager solves; (b) Algorithm 6; (c)
   ``ExperimentSpec()`` with one round per selector under SAO and three
   more allocators, the FL kernels' launch counts read from this run
   alone; (d) 5 host-loop rounds of ``rra`` (a set size that changes from
   round to round) with the solves' graphs and with every solve eager,
   which must agree;
8. the device-resident run: two ``ExperimentSpec()`` experiments from one
   seed, the initial round and 5 rounds, one through ``run()`` (the round
   captured as a CUDA graph, replayed once a round) and one through the
   host loop, which must agree; the capture's time, each path's ms a
   round, one replay under ``torch.profiler`` (its device launches, idle
   share of its own device window and the FL kernels inside it), and a
   whole traced run under the profiler, whose FL kernel launches are the
   path's counts;
9. seed cohorts (``build_cohort``): (a) ``ExperimentSpec(cohort=8)``, the
   initial round and 3 replays of ONE captured round for the 8 lanes,
   under ``transfer_guard`` (a host sync raises), each lane held to its
   seed's single traced run; the cohort's replay against one seed's, one
   cohort replay profiled, device memory; (b) cohorts of 4 under
   ``kmeans_random`` and ``random``, their traced draws, against single
   traced runs fed the same draws; in (a) and (b) a whole guarded run
   under the profiler gives the path's kernel launches; (c) the quick
   cell of Fig. 10/11 and Table III (four methods, seeds 0 and 17);
10. the wireless scenario: (a) tiny runs on the CPU and on the card from
    the same draws — a 2-cell ``multicell-dynamic`` (ρ = 0.9) cohort with
    FedAvgM and int8, a single cell under ``topk:0.01``; (b) the 3-cell
    dynamic cohort of 2 seeds at full width (6 lanes of ONE captured
    round, the initial round and 3 replays) under ``transfer_guard`` and,
    once more, under the profiler (the path's kernel launches); its
    replay against one single-cell seed's; (c) a static 2-cell cohort, each
    cell lane against its ``build_experiment(spec, cell=c)`` run; (d)
    ``topk:0.01`` with FedAvgM, traced against the host loop, and SAO's T
    with the compressed payload below T with the full one; (e)
    ``rayleigh-block`` against ``gauss-markov:0`` from the same draws;
11. the paged client store: (a) ``ExperimentSpec(clients=1000)`` on the
    paged store (one active plane for the initial round, 8 chunks of 128
    rows, the exact refresh) through ``run()`` against the dense host loop
    from the same seed, the initial round and 3 rounds, bit for bit
    (selections, T_k, E_k, the global row, divergences, the client tree),
    each path's kernel launches equal to the counts derived from its
    code; (b) 4000 clients: the initial round in 8 waves of 500 (the
    streaming mean against one fold of the plane assembled on the card),
    the minibatch K-means over 28 chunks, 3 rounds on the drift-bounded
    divergence (every client's true divergence within its bound), no
    allocation as large as the ``[N, P]`` plane; (c) 1e5 and 1e6 clients
    under churn (lazy, vectorized partitions): 5 timed rounds each, the
    rest of a round at 1e6 within 1.5x of 1e5's, the device's peak
    growing by no more than the per-client data;
12. the buffered-asynchronous engine: (a) a tiny ``fedbuff:2:0.5`` run
    under churn on the CPU and on the card from the same draws, which must
    agree; (b) ``ExperimentSpec(aggregator="fedbuff:10:0")`` against
    ``ExperimentSpec()`` traced, 5 ticks, bit for bit; (c)
    ``fedbuff:4:0.5`` with churn 0.05/0.2 at full width for 8 ticks: one
    capture and one replay a tick, 0 host syncs, staleness > 0 on some
    tick and at most 4 updates a fire, no unavailable client dispatched
    (tick by tick), ms a tick against the synchronous replay, the
    kernels' launches held to the counts derived from the tick's code,
    one replay profiled; (d) the same with ``cohort=2``: one captured
    tick for both lanes, each lane its seed's single run bit for bit; (e)
    200 clients under ``icas``, the dense tick against the paged store's
    four pieces, 3 ticks, bit for bit; (f) the paged tick at 1e5 and 1e6
    clients (``random``, S = 16, ``fedbuff:4``): the rest of a tick at
    1e6 within 1.5x of 1e5's, the device's peak growing by no more than
    the per-client columns;
13. faults, quarantine and checkpoint/resume (``repro_torch.core.faults``,
    ``repro_torch.train.checkpoint``): (a) a tiny faulty host loop
    (``outage:0.2,corrupt:0.2,byzantine:0.1``, quarantine after 1 strike)
    on the CPU and on the card from the same draws, under ``trimmed:0.2``
    and ``clipnorm:1.0``: selections and counts equal, the row within
    1e-4; (b) ``ExperimentSpec(faults="outage:0.1,corrupt:0.05,
    byzantine:0.1", quarantine_after=2, aggregator="trimmed:0.2")``, 5
    rounds, traced against the host loop bit for bit, 0 host syncs, the
    faulty replay beside ``ExperimentSpec()``'s (ms, launches, idle
    share), the path's kernel launches; (c) a deadline above the rounds'
    T* (the deadline-free run bit for bit) and far below it (every round
    the all-failed no-op); (d) 200 clients under churn and faults, the
    dense tick against the paged pieces bit for bit; (e) kill and resume
    on the dense host loop, the paged loop and the paged asynchronous
    loop, 6 rounds against 3 + a snapshot + 3, bit for bit; (f)
    ``flat_aggregate`` with NaN rows at weight 0 at [10, 113744], the live
    rows' fold bit for bit, its ms against its bound;
14. the entry points (``repro_torch.launch``): (a) ``fl_sim.main``
    in-process with the README's Quickstart flags and ``--rounds 3``,
    which must print what ``run_spec(ExperimentSpec(dataset="fashion",
    rounds=3))`` gives bit for bit; ``--dump-spec`` through ``--spec``;
    4 rounds with ``--checkpoint-every 1``, the snapshots after round 2
    removed, then ``--resume``: the uninterrupted run bit for bit;
    ``--cohort 2 --rounds 2``; (b) LoRA-LM lanes at the published widths
    of tinyllama-1.1b and mamba2-130m: ``build_cohort`` of 2 seeds, the
    initial round and one replay of ONE captured round, under
    ``transfer_guard``, each lane its seed's single traced run bit for
    bit, the cohort's replay beside one seed's, one replay profiled (the
    four kernels inside it); (c) ``launch.serve`` at the published
    widths (batch 4, 8-token prompt, 32 tokens, greedy; tok/s), the
    prompt's decode logits against ``forward`` within 1e-4; (d)
    ``launch.train`` at the published widths (5 AdamW steps of 8 × 128
    tokens; s/step, peak memory), and one smoke-config step on the card
    against the CPU within 1e-4;
15. the remaining model families (MoE, hybrid, encoder-decoder, VLM):
    (a) ``launch.serve`` over granite-moe-3b-a800m at its published config
    (3.37 B parameters; batch 4, an 8-token prompt, 32 tokens, greedy),
    decode logits against ``forward`` within 1e-4, tok/s and the peak
    memory; (b) one granite MoE layer at published width on 8 × 128
    tokens: ``dense_fused`` ≡ ``dense`` within 1e-5, ``dispatch`` at
    capacity E/k within 1e-4, the default capacity, each second call bit
    for bit; (c) ``make_train_step`` over granite at published width cut
    to 8 of 32 layers, 5 AdamW steps of 8 × 128 tokens under ``dense``
    and ``dispatch`` (aux > 0; s/step, peak memory); (d)
    seamless-m4t-medium at its published config: ``launch.serve`` with
    32 frames of ``src_embeds`` (decode ≡ ``forward`` within 1e-4; the
    encoder's non-causal ``flash_attention`` launches counted) and
    ``launch.train``; (e) jamba at its smoke config: ``forward`` (its
    ``flash_attention`` and ``ssd_scan`` launches counted), decode ≡
    ``forward``, a train step; (f) the eight new smoke configs on the card
    against the CPU within 1e-5, and phi-3-vision's head dim 96 at
    published width raising the kernel's ``ValueError``;
16. a ``kernels`` JSON line, then ``{"ok": true, "device": {...}}`` last.

It exits non-zero and prints no result when there is no CUDA card or when
the port's sources are missing.
"""
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
TF32X3_FLOP_PER_S = 495e12 / 3   # TF32 tensor cores, three products each
AGG_TOL = dict(rtol=2e-5, atol=2e-5)
L2_TOL = dict(rtol=1e-4, atol=1e-3)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)    # fp32, another summation order
SSD_TOL = dict(rtol=1e-4, atol=1e-4)     # the reference's ssd_ref bound
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)    # gradients (test_torch_*: 1e-4)
SSD_GRAD_NORMWISE = 1e-5   # the SSD gradient at S = 128, of max |w| (fp32)
P_MNIST = 113_744
P_TINYLLAMA, P_MAMBA2 = 563_200, 616_704      # the LM paths' adapter rows
F_TINYLLAMA = 22_528             # its K-means features (the last LoRA leaf)
SLAB_TARGETS = (264, 528, 1056)  # pairwise_l2 block targets swept in phase 2
DEVICE = "cuda"
KERNELS = ("flat_aggregate", "pairwise_l2", "flash_attention", "ssd_scan")
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")   # profiler activities


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
    The flush and a spin of about 0.1 ms (``torch.cuda._sleep``) keep the
    device busy while the host enqueues the call, so the events time the
    call's own device work and not the host's Python around it."""

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
            torch.cuda._sleep(200_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def device_launches(torch, fn):
    """The device kernels, copies and memsets that one call of ``fn``
    enqueues (after one call outside the profiler), between marks as
    ``profiled_device_work`` takes them, fewer of them: without, the
    profiler once dropped a call's only record; a CUDA graph's replay
    counts each of its kernels."""
    fn()
    torch.cuda.synchronize()
    return len(profiled_device_work(torch, fn, "the call",
                                    bursts=CALL_MARK_BURSTS)[0])


def is_device_work(e, DeviceType):
    """A profiler event that is device work: the device timeline also
    carries annotations (spans, aten ops), which are not."""
    if e.device_type != DeviceType.CUDA:
        return False
    kind = getattr(e, "activity_type", None)
    return not (e.is_user_annotation or e.name.startswith(("aten::", "fl."))
                or kind not in (None, *DEVICE_WORK))


def bound(nbytes, flops, flop_rate=FP32_FLOP_PER_S):
    """The least time [ms]: bytes over HBM's rate against operations over
    ``flop_rate`` (fp32 outside the tensor cores unless a kernel says
    otherwise), and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rate_name(flop_rate):
    return {FP32_FLOP_PER_S: "fp32 67 TFLOP/s",
            TF32X3_FLOP_PER_S: "3xTF32 495/3 TFLOP/s"}[flop_rate]


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
    from repro_torch.kernels.pairwise_l2 import (_launch, divergence_sq,
                                                 pairwise_l2, plan_divergence,
                                                 plan_slabs)

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = {}
    one = torch.zeros(1, device=DEVICE)
    print(f"  timer floor: one-element add_ ms={timer(lambda: one.add_(1)):.4f}"
          " (the least any call reads under this timer)")

    # the CNN path's folds (N = 10 a round, 40 at the initial round), a
    # wide fleet, and the LM paths' folds (S = 4 a round, N = 10 initially)
    for n, p in ((10, P_MNIST), (40, P_MNIST), (100, P_MNIST),
                 (4, P_TINYLLAMA), (10, P_TINYLLAMA), (4, P_MAMBA2),
                 (4, P_MNIST)):
        flat = torch.randn((n, p), generator=gen, device=DEVICE)
        w = torch.rand((n,), generator=gen, device=DEVICE) + 0.1
        flat[n // 2] = float("nan")              # a NaN row at weight 0
        w[n // 2] = 0.0
        w = w / w.sum()
        got, want = flat_aggregate(flat, w), flat_aggregate_plain(flat, w)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"flat_aggregate [{n},{p}]: non-finite output")
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, **AGG_TOL)
        live = int((w > 0).sum())                 # rows the kernel reads
        b_ms, b_by = bound(live * p * 4 + n * 4 + p * 4, 2 * live * p)
        flat_lib = torch.where(w[:, None] > 0, flat,
                               torch.zeros((), device=DEVICE))
        r = dict(shape=[n, p], max_abs_err=err, ok=bool(ok),
                 device_launches_per_call=device_launches(
                     torch, lambda: flat_aggregate(flat, w)),
                 ms=timer(lambda: flat_aggregate(flat, w)),
                 plain_ms=timer(lambda: flat_aggregate_plain(flat, w)),
                 library_ms=timer(lambda: torch.mv(flat_lib.t(), w)),
                 bound_ms=b_ms, bound_by=b_by,
                 bound_rate=rate_name(FP32_FLOP_PER_S))
        print(f"  flat_aggregate [{n},{p}] max_abs_err={err:.3e} "
              f"(tol rtol/atol 2e-5: {'ok' if ok else 'FAIL'}) "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms(torch.mv)={r['library_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) "
              f"bound_share={b_ms / r['ms']:.3f} "
              f"device_launches/call={r['device_launches_per_call']}")
        check(ok, f"flat_aggregate [{n},{p}] disagrees with its "
                  f"plain version: max_abs_err={err}")
        rows.setdefault("flat_aggregate", []).append(r)
        del flat, flat_lib

    # the CNN path's K-means (w_fc2: the dense fit, a minibatch chunk) and
    # divergence (the dense plane; the paged store's chunks, base row and
    # 1000-row plane); the tinyllama path's divergence (S = 4 a round,
    # N = 10 initially) and K-means (c = 4). A divergence (m = 1) runs
    # the plan of P alone (divergence_sq), a K-means call plan_slabs.
    for n, m, f in ((40, 10, 2240), (40, 1, P_MNIST), (10, 1, P_TINYLLAMA),
                    (10, 4, F_TINYLLAMA), (147, 1, P_MNIST),
                    (128, 1, P_MNIST), (1, 1, P_MNIST), (1000, 1, P_MNIST),
                    (147, 10, 2240), (4, 1, P_MNIST)):
        x = torch.randn((n, f), generator=gen, device=DEVICE)
        c = torch.randn((m, f), generator=gen, device=DEVICE)
        fn = divergence_sq if m == 1 else pairwise_l2
        got, want = fn(x, c), ref.pairwise_l2_ref(x, c)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, **L2_TOL)
        b_ms, b_by = bound((n * f + m * f + n * m) * 4, 3 * n * m * f)
        slabs = (plan_divergence(f) if m == 1 else plan_slabs(n, m, f))[0]
        per_call = device_launches(torch, lambda: fn(x, c))
        check(per_call == (1 if slabs == 1 else 2),
              f"pairwise_l2 [{n},{f}]x[{m},{f}]: {per_call} device launches "
              f"a call with {slabs} slabs")
        r = dict(shape=[n, m, f], max_abs_err=err, ok=bool(ok),
                 slabs=slabs, device_launches_per_call=per_call,
                 ms=timer(lambda: fn(x, c)),
                 plain_ms=timer(lambda: ref.pairwise_l2_ref(x, c)),
                 library_ms=timer(lambda: torch.cdist(x, c).square()),
                 bound_ms=b_ms, bound_by=b_by,
                 bound_rate=rate_name(FP32_FLOP_PER_S))
        sweep = ""
        if m == 1:
            # the plan of the rows in the call, which the divergence ran on
            # until its bits had to be the same at every row count
            r["rows_plan_ms"] = timer(
                lambda: _launch(x, c, *plan_slabs(n, m, f)))
            sweep = (f" plan_slabs(n) ({plan_slabs(n, m, f)[0]} slabs) "
                     f"ms={r['rows_plan_ms']:.4f}")
        else:
            # the slab plan's block target, swept in this call
            # (TARGET_BLOCKS is the one the wrapper uses)
            r["slab_target_ms"] = {
                t: timer(lambda t=t: _launch(x, c, *plan_slabs(n, m, f, t)))
                for t in SLAB_TARGETS}
            sweep = " slab target sweep ms: " + ", ".join(
                f"{t} blocks ({plan_slabs(n, m, f, t)[0]} slabs)={ms:.4f}"
                for t, ms in r["slab_target_ms"].items())
        print(f"  pairwise_l2 [{n},{f}]x[{m},{f}] max_abs_err={err:.3e} "
              f"(tol rtol 1e-4 atol 1e-3: {'ok' if ok else 'FAIL'}) "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms(cdist^2)={r['library_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) slabs={slabs} "
              f"device_launches/call={per_call}{sweep}")
        check(ok, f"pairwise_l2 [{n},{f}]x[{m},{f}] disagrees with its "
                  f"plain version: max_abs_err={err}")
        rows.setdefault("pairwise_l2", []).append(r)
    for lanes in (8, 6):        # phase 9's seed cohort, phase 10's cells
        for name, r in lane_kernel_rows(torch, timer, gen, lanes).items():
            rows[name].append(r)
    # phase 12(d)'s asynchronous cohort: the fold of each lane's M = 4
    # candidates, one launch for both lanes
    rows["flat_aggregate"].append(lane_kernel_rows(
        torch, timer, gen, 2, n=4, divergence=False)["flat_aggregate"])
    # phase 14(b)'s LoRA-LM cohorts of 2: the initial round's fold of the
    # 10 clients and the divergence of 10 rows of a [2, 14, P] plane
    for p in (P_TINYLLAMA, P_MAMBA2):
        for name, r in lane_kernel_rows(torch, timer, gen, 2, p=p,
                                        div_rows=(10, 14)).items():
            rows[name].append(r)
    rows["flash_attention"] = (attention_rows(torch, timer, gen)
                               + [attention_grad_row(torch, timer, gen)])
    rows["ssd_scan"] = ssd_rows(torch, timer, gen)
    return rows


def lane_kernel_rows(torch, timer, gen, lanes=8, n=10, divergence=True,
                     p=P_MNIST, div_rows=(40, 50)):
    """(d) The lane forms on the cohort paths (phase 9's 8 lanes, phase
    10's 6: 2 seeds × 3 cells; phase 12(d)'s 2, its fold of ``n`` = 4
    candidates a lane, without ``divergence``; phase 14(b)'s 2 LoRA-LM
    lanes at ``p`` = the adapter row, the divergence of ``div_rows`` = 10
    clients of a 14-row plane), here for 8:
    ``flat_aggregate`` at [8, 10, 113744] (a round's fold, every lane in
    one launch) and ``pairwise_l2`` at [8, 40, 113744] × [8, 1, 113744]
    (the divergence: the first 40 rows of each lane of an [8, 50, 113744]
    plane, read in place), each against its plain version at the 2-D
    rows' tolerances. Library yardsticks in lane form: ``torch.bmm`` and
    ``torch.cdist(...).square()``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flat_aggregate import (flat_aggregate,
                                                    flat_aggregate_plain)
    from repro_torch.kernels.pairwise_l2 import divergence_sq, plan_divergence

    out = {}
    flat = torch.randn((lanes, n, p), generator=gen, device=DEVICE)
    w = torch.rand((lanes, n), generator=gen, device=DEVICE) + 0.1
    flat[:, n // 2] = float("nan")              # a NaN row at weight 0
    w[:, n // 2] = 0.0
    w = w / w.sum(dim=-1, keepdim=True)
    got, want = flat_aggregate(flat, w), flat_aggregate_plain(flat, w)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()),
          f"flat_aggregate [{lanes},{n},{p}]: non-finite output")
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **AGG_TOL))
    live = int((w > 0).sum())
    b_ms, b_by = bound(live * p * 4 + lanes * n * 4 + lanes * p * 4,
                       2 * live * p)
    flat_lib = torch.where(w[..., None] > 0, flat,
                           torch.zeros((), device=DEVICE))
    per_call = device_launches(torch, lambda: flat_aggregate(flat, w))
    check(per_call == 1, f"flat_aggregate [{lanes},{n},{p}]: {per_call} "
                         "device launches a call, not one for every lane")
    r = dict(shape=[lanes, n, p], max_abs_err=err, ok=ok,
             device_launches_per_call=per_call,
             ms=timer(lambda: flat_aggregate(flat, w)),
             plain_ms=timer(lambda: flat_aggregate_plain(flat, w)),
             library_ms=timer(lambda: torch.bmm(w[:, None, :], flat_lib)),
             bound_ms=b_ms, bound_by=b_by,
             bound_rate=rate_name(FP32_FLOP_PER_S))
    print(f"  flat_aggregate lanes [{lanes},{n},{p}] max_abs_err={err:.3e} "
          f"(tol rtol/atol 2e-5: {'ok' if ok else 'FAIL'}) "
          f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"library_ms(torch.bmm)={r['library_ms']:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / r['ms']:.3f} "
          f"device_launches/call={per_call}")
    check(ok, f"flat_aggregate [{lanes},{n},{p}] disagrees with its plain "
              f"version: max_abs_err={err}")
    out["flat_aggregate"] = r
    del flat, flat_lib
    if not divergence:
        return out

    (n, rows_n), m = div_rows, 1
    plane = torch.randn((lanes, rows_n, p), generator=gen, device=DEVICE)
    x = plane[:, :n]                    # a view: each lane at its stride
    c = torch.randn((lanes, m, p), generator=gen, device=DEVICE)
    got, want = divergence_sq(x, c), ref.pairwise_l2_ref(x, c)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **L2_TOL))
    b_ms, b_by = bound((lanes * n * p + lanes * m * p + lanes * n * m) * 4,
                       3 * lanes * n * m * p)
    slabs = plan_divergence(p)[0]             # each lane's own plan
    per_call = device_launches(torch, lambda: divergence_sq(x, c))
    check(per_call == (1 if slabs == 1 else 2),
          f"pairwise_l2 lanes: {per_call} device launches a call with "
          f"{slabs} slabs")
    shape = [lanes, n, m, p]
    r = dict(shape=shape, max_abs_err=err, ok=ok, slabs=slabs,
             device_launches_per_call=per_call,
             ms=timer(lambda: divergence_sq(x, c)),
             plain_ms=timer(lambda: ref.pairwise_l2_ref(x, c)),
             library_ms=timer(lambda: torch.cdist(x, c).square()),
             bound_ms=b_ms, bound_by=b_by,
             bound_rate=rate_name(FP32_FLOP_PER_S))
    print(f"  pairwise_l2 lanes [{lanes},{n},{p}] (of [{lanes},{rows_n},{p}])"
          f"x[{lanes},{m},{p}] max_abs_err={err:.3e} (tol rtol 1e-4 atol "
          f"1e-3: {'ok' if ok else 'FAIL'}) ms={r['ms']:.4f} "
          f"plain_ms={r['plain_ms']:.4f} library_ms(cdist^2)="
          f"{r['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"slabs={slabs} device_launches/call={per_call}")
    check(ok, f"pairwise_l2 lanes disagree with the plain version: "
              f"max_abs_err={err}")
    out["pairwise_l2"] = r
    del plane, x, c
    return out


def attention_rows(torch, timer, gen):
    """``flash_attention`` against its plain version: the tinyllama FL path
    (S = 32), long causal and windowed sequences, one query against a long
    cache, Sq > Sk (rows with no key must be 0) and the smoke width D = 16;
    then the shapes of the remaining model families (phase 15): granite's
    train batch (GQA 24/8, H/K = 3), seamless's non-causal encoder at its
    train and serve batches. Library yardstick:
    ``scaled_dot_product_attention`` on the same inputs (heads first, KV
    heads repeated and the boolean mask built outside the timed call)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for b, sq, sk, h, kv, d, causal, window in (
            (8, 32, 32, 32, 4, 64, True, None),   # the FL path (tinyllama)
            (8, 128, 128, 32, 4, 64, True, None),  # launch.train's batch
            (1, 2048, 2048, 32, 4, 64, True, None),
            (1, 2048, 2048, 32, 4, 64, True, 512),
            (1, 1, 2048, 32, 4, 64, True, None),
            (2, 96, 40, 32, 4, 64, True, None),    # Sq > Sk
            (8, 32, 32, 8, 2, 16, True, None),     # the smoke width
            (8, 128, 128, 24, 8, 64, True, None),  # granite train (15c)
            (8, 128, 128, 16, 16, 64, False, None),  # seamless encoder
            (4, 32, 32, 16, 16, 64, False, None)):   # train (15d), serve
        q = torch.randn((b, sq, h, d), generator=gen, device=DEVICE)
        k = torch.randn((b, sk, kv, d), generator=gen, device=DEVICE)
        v = torch.randn((b, sk, kv, d), generator=gen, device=DEVICE)
        kw = dict(causal=causal, window=window)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, **ATTN_TOL))
        if sq > sk:
            ok = ok and int(torch.count_nonzero(got[:, :sq - sk])) == 0
        qpos = torch.arange(sq, device=DEVICE)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=DEVICE)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=DEVICE)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= (qpos - kpos) < window
        pairs = int(mask.sum())               # the unmasked (q, k) pairs
        b_ms, b_by = bound(4 * (2 * b * sq * h * d + 2 * b * sk * kv * d),
                           4 * d * b * h * pairs, TF32X3_FLOP_PER_S)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
        plain_mask = sq == sk and window is None    # no mask or is_causal
        shape = f"q[{b},{sq},{h},{d}] kv[{b},{sk},{kv},{d}] " + (
            f"window={window}" if window else
            "causal" if causal else "non-causal")
        r = dict(shape=shape, max_abs_err=err, ok=ok,
                 device_launches_per_call=device_launches(
                     torch, lambda: flash_attention(q, k, v, **kw)),
                 ms=timer(lambda: flash_attention(q, k, v, **kw)),
                 plain_ms=timer(lambda: flash_attention_plain(q, k, v, **kw)),
                 library_ms=timer(lambda: sdpa(
                     qt, kt, vt, is_causal=causal and plain_mask,
                     attn_mask=None if plain_mask else mask)),
                 bound_ms=b_ms, bound_by=b_by,
                 bound_rate=rate_name(TF32X3_FLOP_PER_S))
        print(f"  flash_attention {shape} max_abs_err={err:.3e} (tol "
              f"rtol/atol 2e-5{', masked rows 0' if sq > sk else ''}: "
              f"{'ok' if ok else 'FAIL'}) ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms(sdpa)="
              f"{r['library_ms']:.4f} bound_ms={b_ms:.5f} ({b_by}, "
              f"{r['bound_rate']}) "
              f"device_launches/call={r['device_launches_per_call']}")
        check(ok, f"flash_attention {shape} disagrees with its plain "
                  f"version: max_abs_err={err}")
        out.append(r)
        del q, k, v, qt, kt, vt, got, want
    return out


def attention_grad_row(torch, timer, gen):
    """Forward plus backward of ``flash_attention`` at ``launch.train``'s
    tinyllama shape (batch 8, 128 tokens, GQA 32/4): the kernel's forward,
    the gradient through the plain version's autograd (as the wrapper
    does), against autograd through the plain version alone. Library
    yardstick: ``scaled_dot_product_attention`` forward and backward on
    the heads-first, KV-repeated inputs. The bound counts the forward's
    bytes plus the backward's (q, k, v and the cotangent read, three
    gradients written) and 3.5 times the forward's flops (the backward
    recomputes the scores and makes four products)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, s, h, kv, d = 8, 128, 32, 4, 64
    leaves = [torch.randn(shape, generator=gen, device=DEVICE)
              .requires_grad_(True)
              for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]
    wo = torch.randn((b, s, h, d), generator=gen, device=DEVICE)

    def step(fn):
        return torch.autograd.grad(fn(*leaves), leaves, wo)

    got = step(lambda q, k, v: flash_attention(q, k, v))
    want = step(lambda q, k, v: flash_attention_plain(q, k, v))
    torch.cuda.synchronize()
    err = max(float((g1 - g2).abs().max()) for g1, g2 in zip(got, want))
    ok = all(bool(torch.allclose(g1, g2, **GRAD_TOL))
             for g1, g2 in zip(got, want))
    lib = [t.detach().repeat_interleave(h // t.shape[2], dim=2)
           .transpose(1, 2).contiguous().requires_grad_(True)
           for t in leaves]
    wo_t = wo.transpose(1, 2).contiguous()
    pairs = s * (s + 1) // 2
    nbytes = 4 * (2 * b * s * h * d + 2 * b * s * kv * d) * 2
    b_ms, b_by = bound(nbytes, 3.5 * 4 * d * b * h * pairs,
                       TF32X3_FLOP_PER_S)
    shape = f"forward+backward q[{b},{s},{h},{d}] kv[{b},{s},{kv},{d}] causal"
    r = dict(shape=shape, max_abs_err=err, ok=ok,
             device_launches_per_call=device_launches(
                 torch, lambda: step(lambda q, k, v: flash_attention(q, k, v))),
             ms=timer(lambda: step(lambda q, k, v: flash_attention(q, k, v)),
                      reps=10),
             plain_ms=timer(lambda: step(
                 lambda q, k, v: flash_attention_plain(q, k, v)), reps=10),
             library_ms=timer(lambda: torch.autograd.grad(
                 sdpa(*lib, is_causal=True), lib, wo_t), reps=10),
             bound_ms=b_ms, bound_by=b_by,
             bound_rate=rate_name(TF32X3_FLOP_PER_S))
    print(f"  flash_attention {shape}: max grad err={err:.3e} (tol rtol/atol "
          f"1e-4: {'ok' if ok else 'FAIL'}) ms={r['ms']:.4f} plain_ms="
          f"{r['plain_ms']:.4f} library_ms(sdpa fwd+bwd)="
          f"{r['library_ms']:.4f} bound_ms={b_ms:.5f} ({b_by}, "
          f"{r['bound_rate']}) device_launches/call="
          f"{r['device_launches_per_call']}")
    check(ok, f"flash_attention gradients disagree with the plain "
              f"version's: max_abs_err={err}")
    return r


def ssd_inputs(torch, gen, b, s, h, p, n):
    x = torch.randn((b, s, h, p), generator=gen, device=DEVICE)
    a = -(torch.rand((b, s, h), generator=gen, device=DEVICE) + 1e-3)
    bm = torch.randn((b, s, 1, n), generator=gen, device=DEVICE) / n ** 0.5
    cm = torch.randn((b, s, 1, n), generator=gen, device=DEVICE) / n ** 0.5
    return x, a, bm, cm


def ssd_cost(b, s, h, p, n, q):
    """(bytes, flops) of one forward call: x, a, b, c read once, y and the
    state written once. Per (b·h, chunk of Ql steps): Ql (Ql + 1) (N + P)
    flops for C·Bᵀ and its product with X over the j ≤ i triangle, 2 Ql P N
    for the chunk state and, in each chunk after the first, 2 Ql P N for
    the carried read-out C·h_inᵀ and 2 P N for passing the state on."""
    lens = [min(q, s - t0) for t0 in range(0, s, q)]
    flops = b * h * sum(ql * (ql + 1) * (n + p) + 2 * ql * p * n
                        + (2 * ql * p * n + 2 * p * n if i else 0)
                        for i, ql in enumerate(lens))
    return 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n
                + b * h * p * n), flops


def ssd_rows(torch, timer, gen):
    """``ssd_scan`` against its plain version (the token-by-token
    recurrence): the mamba2-130m FL path (S = 32, so Q = 32), one sequence
    at the published chunk (Q = 256), a ragged S and jamba's smoke shape
    (phase 15(e): P = 32, N = 16, two chunks of 32); then the forward plus
    backward at the FL shape against autograd through the plain version.
    No one PyTorch call computes this function: ``library_ms`` is null."""
    from repro_torch.kernels.ssd_scan import plan_ssd, ssd_scan, ssd_scan_plain
    out = []
    for b, s, h, p, n, chunk in ((8, 32, 24, 64, 128, 256),
                                 (8, 128, 24, 64, 128, 256),  # launch.train
                                 (1, 2048, 24, 64, 128, 256),
                                 (1, 300, 24, 64, 128, 256),
                                 (4, 64, 8, 32, 16, 32)):     # jamba (15e)
        x, a, bm, cm = ssd_inputs(torch, gen, b, s, h, p, n)
        y, st = ssd_scan(x, a, bm, cm, chunk=chunk)
        y_p, st_p = ssd_scan_plain(x, a, bm, cm)
        torch.cuda.synchronize()
        err = max(float((y - y_p).abs().max()), float((st - st_p).abs().max()))
        ok = bool(torch.allclose(y, y_p, **SSD_TOL)
                  and torch.allclose(st, st_p, **SSD_TOL))
        plan = plan_ssd(b, s, h, p, n, chunk)
        per_call = device_launches(
            torch, lambda: ssd_scan(x, a, bm, cm, chunk=chunk))
        check(per_call == plan.launches,
              f"ssd_scan: {per_call} device launches a call, the plan says "
              f"{plan.launches}")
        b_ms, b_by = bound(*ssd_cost(b, s, h, p, n, plan.q),
                           TF32X3_FLOP_PER_S)
        shape = f"x[{b},{s},{h},{p}] bc[{b},{s},1,{n}] Q={plan.q}"
        r = dict(shape=shape, max_abs_err=err, ok=ok,
                 device_launches_per_call=per_call,
                 ms=timer(lambda: ssd_scan(x, a, bm, cm, chunk=chunk)),
                 plain_ms=timer(lambda: ssd_scan_plain(x, a, bm, cm),
                                reps=5, warm=1),
                 library_ms=None, bound_ms=b_ms, bound_by=b_by,
                 bound_rate=rate_name(TF32X3_FLOP_PER_S))
        print(f"  ssd_scan {shape} max_abs_err={err:.3e} (tol rtol/atol "
              f"1e-4: {'ok' if ok else 'FAIL'}) ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms=null "
              f"bound_ms={b_ms:.5f} ({b_by}, {r['bound_rate']}) "
              f"device_launches/call={per_call}")
        check(ok, f"ssd_scan {shape} disagrees with its plain version: "
                  f"max_abs_err={err}")
        out.append(r)
        del x, a, bm, cm, y, st, y_p, st_p
    out.append(ssd_grad_row(torch, timer, gen))
    out.append(ssd_grad_row(torch, timer, gen, s=128))    # launch.train
    return out


def ssd_grad_row(torch, timer, gen, s=32):
    """Forward plus backward of ``ssd_scan`` at the FL shape (S = 32), or at
    ``launch.train``'s (S = 128) (the kernel, then autograd through the
    chunked form) against autograd through the plain recurrence,
    cotangents on y and on the state. At the FL shape every element is
    held to rtol/atol 1e-4; at S = 128 each gradient is held normwise,
    max |g − w| ≤ ``SSD_GRAD_NORMWISE`` · max |w|: a chunk of 128 steps
    sums 4× the terms, and the chunked form's own fp32 error (dB 2.4e-4
    on entries up to 120 against a float64 recurrence on the CPU, 2e-6
    of the largest) passes the per-element atol. The bound counts the
    forward's bytes plus the backward's (x, a, b, c and both cotangents
    read, four gradients written) and three times the forward's flops
    (each product's gradient is two products) at the 3xTF32 rate."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    b, h, p, n, chunk = 8, 24, 64, 128, 256
    leaves = [t.requires_grad_(True)
              for t in ssd_inputs(torch, gen, b, s, h, p, n)]
    wy = torch.randn((b, s, h, p), generator=gen, device=DEVICE)
    ws = torch.randn((b, h, p, n), generator=gen, device=DEVICE)

    def step(fn):
        y, st = fn(*leaves)
        return torch.autograd.grad([y, st], leaves, [wy, ws])

    got = step(lambda *t: ssd_scan(*t, chunk=chunk))
    want = step(ssd_scan_plain)
    torch.cuda.synchronize()
    err = max(float((g1 - g2).abs().max()) for g1, g2 in zip(got, want))
    if s <= 32:
        ok = all(bool(torch.allclose(g1, g2, **SSD_TOL))
                 for g1, g2 in zip(got, want))
    else:
        ok = all(float((g1 - g2).abs().max())
                 <= SSD_GRAD_NORMWISE * float(g2.abs().max())
                 for g1, g2 in zip(got, want))
    # how near each gradient sits to allclose's limit: max |g − w| /
    # (atol + rtol |w|), which allclose holds at ≤ 1
    ratio = {name: float(((g1 - g2).abs() / (SSD_TOL["atol"] + SSD_TOL["rtol"]
                                              * g2.abs())).max())
             for name, g1, g2 in zip(("x", "a", "b", "c"), got, want)}
    worst = max(ratio, key=ratio.get)
    per_call = device_launches(
        torch, lambda: step(lambda *t: ssd_scan(*t, chunk=chunk)))
    plain_calls = device_launches(torch, lambda: step(ssd_scan_plain))
    nbytes, flops = ssd_cost(b, s, h, p, n, min(chunk, s))
    nbytes += 4 * 2 * (2 * b * s * h * p + b * s * h + 2 * b * s * n
                       + b * h * p * n)
    b_ms, b_by = bound(nbytes, 3 * flops, TF32X3_FLOP_PER_S)
    shape = f"forward+backward x[{b},{s},{h},{p}] bc[{b},{s},1,{n}] Q={s}"
    r = dict(shape=shape, max_abs_err=err, ok=ok,
             allclose_ratio=ratio, allclose_ratio_max_leaf=worst,
             device_launches_per_call=per_call,
             plain_device_launches_per_call=plain_calls,
             ms=timer(lambda: step(lambda *t: ssd_scan(*t, chunk=chunk)),
                      reps=10),
             plain_ms=timer(lambda: step(ssd_scan_plain), reps=5, warm=1),
             library_ms=None, bound_ms=b_ms, bound_by=b_by,
             bound_rate=rate_name(TF32X3_FLOP_PER_S))
    tol = ("rtol/atol 1e-4" if s <= 32 else
           f"normwise {SSD_GRAD_NORMWISE:g} of max |w|: "
           + " ".join(f"d{k} {float((g1 - g2).abs().max()):.2e} of "
                      f"{float(g2.abs().max()):.3g}" for k, g1, g2 in
                      zip("xabc", got, want)))
    r["tol"] = tol
    print(f"  ssd_scan {shape}: max grad err={err:.3e} (tol {tol}: "
          f"{'ok' if ok else 'FAIL'}) allclose ratio "
          + " ".join(f"d{k}={v:.3f}" for k, v in ratio.items())
          + f" (largest: d{worst}) ms={r['ms']:.4f} plain_ms="
          f"{r['plain_ms']:.4f} library_ms=null bound_ms={b_ms:.5f} "
          f"({b_by}, {r['bound_rate']}) device_launches/call={per_call} "
          f"(plain: {plain_calls})")
    check(ok, f"ssd_scan gradients disagree with the plain version's: "
              f"max_abs_err={err}")
    return r


class _CpuDraws:
    """The default draws made on the CPU and moved to ``device``, so one
    seed gives the same numbers (a frozen LM base included) to a CPU run
    and a card run."""

    def __init__(self, seed, device):
        from repro_torch.core.draws import TorchDraws
        self.inner = TorchDraws(seed, "cpu")
        self.device = device

    def init_params(self, model_cfg):
        return {k: v.to(self.device)
                for k, v in self.inner.init_params(model_cfg).items()}

    def base_params(self, model_cfg):
        return {k: v.to(self.device)
                for k, v in self.inner.base_params(model_cfg).items()}

    def batch_indices(self, *args):
        return self.inner.batch_indices(*args).to(self.device)

    def channel_init(self, shape):
        return self.inner.channel_init(shape).to(self.device)

    def channel_step(self, shape):
        return self.inner.channel_step(shape).to(self.device)

    def churn_step(self, n):
        return tuple(u.to(self.device) for u in self.inner.churn_step(n))

    def selector_draw(self, kind, n):
        return self.inner.selector_draw(kind, n).to(self.device)

    def kmeans_seed(self, n, c):
        return self.inner.kmeans_seed(n, c).to(self.device)

    def kmeans_choice(self, i, p):
        return self.inner.kmeans_choice(i, p.cpu()).to(self.device)

    def fault_masks(self, spec, shape):
        return self.inner.fault_masks(spec, shape).to(self.device)

    def byzantine(self, spec, n):
        return self.inner.byzantine(spec, n)


def agreement_phase(torch):
    """Tiny experiments on the CPU (plain paths) and on the card (the
    kernels), from the same draws: the card runs must agree. The paper's
    fashion CNN, then the LoRA LM over the tinyllama and mamba2 smoke
    configs (``ExperimentSpec(model=...)``)."""
    from repro_torch.api import ExperimentSpec, build_experiment
    tiny = dict(clients=8, samples_per_client=16, train_samples=160,
                test_samples=80, local_iters=2, batch_size=8,
                devices_per_round=4, num_clusters=4, rounds=2)
    for model in ("cnn", "tinyllama", "mamba2-130m"):
        spec = ExperimentSpec(dataset="fashion", model=model, **tiny)
        out = {}
        for dev in ("cpu", DEVICE):
            exp = build_experiment(spec, device=dev, draws=_CpuDraws(0, dev))
            out[dev] = (exp.run(), exp.global_vec.cpu())
        (h_cpu, g_cpu), (h_gpu, g_gpu) = out["cpu"], out[DEVICE]
        for k, (a, b) in enumerate(zip(h_cpu.selected, h_gpu.selected)):
            check(list(a) == list(b), f"agreement ({model}): round {k} "
                                      f"selected {list(b)} on the card, "
                                      f"{list(a)} on the CPU")
        for name in ("T_k", "E_k"):
            a, b = getattr(h_cpu, name), getattr(h_gpu, name)
            check(all(math.isclose(x, y, rel_tol=2e-3) for x, y in zip(a, b)),
                  f"agreement ({model}): {name} {b} on the card, {a} on the "
                  "CPU")
        err = float((g_cpu - g_gpu).abs().max())
        acc = max(abs(x - y) for x, y in zip(h_cpu.accuracy, h_gpu.accuracy))
        print(f"  tiny {model} run (P={g_cpu.numel()}), CPU vs card: "
              f"selections equal, T_k/E_k within rtol 2e-3, global row "
              f"max_abs_err={err:.3e} (tol 1e-4), accuracy differs by "
              f"{acc:.4f}")
        check(err <= 1e-4, f"agreement ({model}): global row differs by "
                           f"{err}")


def kernel_fns():
    """Each kernel's wrapper, which carries its launch count."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flat_aggregate import flat_aggregate
    from repro_torch.kernels.pairwise_l2 import pairwise_l2
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"flat_aggregate": flat_aggregate, "pairwise_l2": pairwise_l2,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan}


def check_sao_band(exp, need, what, sel, band):
    """(19c): where problem (19) is feasible the solve keeps Σb within B.
    Where the set's least band (energy budgets met at f_min, computed
    apart from the solver: ``need``) exceeds B, no allocation fits: SAO
    must flag it (converged=False, as the reference's solver does) and
    give each device its least band, capped at B (a device's band never
    exceeds B). Within 1e-3 of B either answer is accepted."""
    import numpy as np
    from repro_torch.core.sao import solve_sao
    from repro_torch.core.wireless import fleet_arrays
    B = exp.B
    sol = solve_sao(fleet_arrays(exp.fleet.select(sel), exp.device), B)
    converged = bool(sol.converged)
    least = float(need[sel].sum())
    capped = float(np.minimum(need[sel], B).sum())
    check(math.isclose(float(sol.b.sum()), band, rel_tol=1e-6),
          f"{what}: the SAO re-solve differs from the run")
    if converged:
        check(band <= B * (1 + 1e-4), f"{what}: SAO converged but uses "
                                      f"{band} MHz of {B}")
    else:
        check(math.isclose(band, capped, rel_tol=1e-4),
              f"{what}: flagged, but Σb={band} MHz is not the least band "
              f"capped at B, {capped} MHz")
    if least <= B * (1 - 1e-3) or least > B:
        check(converged == (least <= B),
              f"{what}: converged={converged}, but the least band is "
              f"{least} MHz of B={B}")
    print(f"  {what}: Σb={band:.4f} MHz of B={B}, least band {least:.4f} "
          f"MHz, capped at B {capped:.4f} MHz ("
          f"{'within B' if converged else 'set infeasible at B: flagged'})")


def drive(torch, exp, rounds, must_launch):
    """The initial round and ``rounds`` rounds of ``exp``'s host loop on the
    card, with every kernel's count set to 0 just before and read just
    after; checks the history, SAO's band use and that each of
    ``must_launch`` ran."""
    fns = kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    hist = exp._run_host(None, rounds, 0.0)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in fns.items()}
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
    check(bool(torch.isfinite(exp.client_plane).all()),
          "non-finite client plane")
    check(len(hist.accuracy) == rounds + 1,
          f"expected the initial round + {rounds} rounds")
    need = least_band_mhz(exp.fleet)
    for k, (sel, band) in enumerate(zip(hist.selected, hist.band_mhz)):
        check_sao_band(exp, need, f"round {k}", sel, band)
    n = exp.fed.num_clients
    for sel in hist.selected[1:]:
        check(0 < len(sel) <= exp.fl.devices_per_round
              and len(set(map(int, sel))) == len(sel)
              and all(0 <= int(i) < n for i in sel),
              f"bad selection {sel}")
    for name in must_launch:
        check(launches[name] > 0, f"{name} was not launched on this path")
    return hist, launches


def main_path_phase(torch, spec):
    """``spec`` on the card for the initial round and 3 rounds; the launch
    counts are read from this run alone."""
    from repro_torch.api import build_experiment

    t0 = time.perf_counter()
    exp = build_experiment(spec, device=DEVICE)
    torch.cuda.synchronize()
    print(f"  build_experiment({spec.dataset} spec) on {exp.device}: "
          f"{time.perf_counter() - t0:.2f} s; P={exp.global_vec.numel()}, "
          f"N={spec.clients}, S={spec.devices_per_round}, "
          f"L={spec.local_iters}")
    _, launches = drive(torch, exp, 3, ("flat_aggregate", "pairwise_l2"))
    return exp, launches


def lm_phase(torch, arch, rounds=2):
    """The federated LM at full width: LoRA adapters over ``arch``'s
    published config, built from the port's own pieces as the reference's
    ``FLExperiment`` takes any registered config. N = 10, S = 4, c = 4,
    L = 2, batch 8, 32-token windows, 16 per client; 160 train and 64 test
    windows. The initial round and ``rounds`` rounds, then one more round
    broken down by phase."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.fedavg import FLExperiment
    from repro_torch.core.wireless import sample_fleet
    from repro_torch.data.partition import partition_bias
    from repro_torch.models import lm

    cfg = lm.LMConfig(model=get_config(arch))
    t0 = time.perf_counter()
    ds = lm.lm_make_dataset(cfg, 160, seed=0)
    test = lm.lm_make_dataset(cfg, 64, seed=10_000)
    fed = partition_bias(ds, 10, 16, 0.8, seed=1)
    fl = FLConfig(num_devices=10, devices_per_round=4, local_iters=2,
                  num_clusters=4, selected_per_cluster=1, max_rounds=rounds)
    exp = FLExperiment(cfg, fed, test.images, test.labels,
                       sample_fleet(10, seed=0), fl, device=DEVICE,
                       batch_size=8, seed=0)
    torch.cuda.synchronize()
    p = exp.global_vec.numel()
    n_base = sum(v.numel() for v in exp.base.values())
    print(f"  {arch}: {cfg.model.num_layers} layers, d_model "
          f"{cfg.model.d_model}, base {n_base} parameters on the card "
          f"(analytic {cfg.model.num_params()}), P_adapter={p}; built in "
          f"{time.perf_counter() - t0:.2f} s")
    check(p == lm.adapter_num_params(cfg), "adapter row width")
    check(bool((abs(exp.fleet.z - p * 32 / 1e6) <= 1e-9).all()),
          f"uploads not priced at P_adapter·32/1e6: {exp.fleet.z[:3]}")
    own = "flash_attention" if cfg.model.family != "ssm" else "ssd_scan"
    torch.cuda.reset_peak_memory_stats()
    hist, launches = drive(torch, exp, rounds,
                           ("flat_aggregate", "pairwise_l2", own))
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; per-dialect accuracy of the last round "
          f"{[round(float(a), 4) for a in hist.per_class[-1]]}")
    ms = profile_phase(torch, exp, reps=1)
    del exp
    lm.base_params.cache_clear()
    torch.cuda.empty_cache()
    return launches, ms


def profile_phase(torch, exp, reps=3):
    """Where one round's time goes. First ``reps`` rounds driven through
    the experiment's own pieces (its round body's phases), host clock with a device sync at the end
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

    ph = exp.phases()
    for _ in range(reps):
        t0 = start = time.perf_counter()
        idx = exp.select()
        t0 = lap("select", t0)
        float(exp.allocation(idx).T)
        t0 = lap("allocate", t0)
        t, state = exp._index(idx), exp._host_state()
        rows = ph.train_rows(state, t, exp._images, exp._labels,
                             exp._batch_indices(len(t)))
        t0 = lap("train", t0)
        ph.fold(state, t, None, rows, exp._sizes)
        t0 = lap("aggregate", t0)
        exp.evaluate()
        lap("evaluate", t0)
        laps["round"].append(time.perf_counter() - start)
    ms = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in laps.items()}
    print(f"  round wall, median of {reps} (no profiler): "
          f"{ms['round']:.1f} ms = " + ", ".join(
              f"{k} {ms[k]:.1f}" for k in ("select", "allocate", "train",
                                           "aggregate", "evaluate")))

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exp.round()
        torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    kinds, by_name = defaultdict(int), defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        kinds[getattr(e, "activity_type", None)] += 1
        if not is_device_work(e, DeviceType):
            continue
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    launches = sum(n for n, _ in by_name.values())
    busy = sum(t for _, t in by_name.values())
    ms["busy"] = busy
    print(f"  one profiled round: {launches} device launches, {busy:.2f} ms "
          f"busy; idle share vs the unprofiled wall "
          f"{1 - busy / ms['round']:.4f} (device event kinds {dict(kinds)}; "
          f"profiled round {t_round:.1f} s, reading the trace "
          f"{time.perf_counter() - t0 - t_round:.1f} s)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    ours = ("flat_aggregate", "pairwise_l2", "slab_sum", "flash_kernel",
            "combine_kernel", "ssd_chunk_kernel", "pass_kernel")
    for i, (name, (n, t)) in enumerate(ranked):
        if i < 6 or any(k in name for k in ours):
            print(f"  kernel #{i + 1} {name[:72]}: {n} launches, {t:.3f} ms")
    return ms

# the port's CPU result is the yardstick of each allocation on the card, at
# the CPU tests' bands: SAO's outer bisection, equal bandwidth's fp32 ops,
# the FEDL grid (its objective; T and E one grid step apart at most)
ALLOC_TOL = {"sao": 2e-3, "equal": 1e-5, "fedl": 1e-2, "fedl_auto": 1e-2}
FEDL_OBJ_TOL = 1e-3


def host_ms(torch, fn, reps=3):
    """Median host wall [ms] of ``reps`` calls of ``fn``, each ending in a
    device sync, and the last call's result."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], out


def fig5_phase(torch):
    """(a) Fig. 5 on the card: every allocator on ``sample_fleet(100,
    seed=0)``'s first ten devices at B = 20 MHz — T, E, ms a call (the
    first call apart: a new shape's first solve runs eager, its second
    captures SAO's or FEDL's graph) and device
    launches a call — each held to the port's CPU result on the same
    inputs; SAO's graph held to its eager solve bit for bit and FEDL's to
    its eager solve on the card; the figure's own assertions
    (``benchmarks/fig5_sao_vs_fedl.py``)."""
    import numpy as np
    from repro_torch.api import ALLOCATORS
    from repro_torch.core import baselines as bl
    from repro_torch.core.graphs import eager_solves
    from repro_torch.core.sao import solve_sao
    from repro_torch.core.wireless import fleet_arrays, sample_fleet

    B = 20.0
    fleet = sample_fleet(100, seed=0).select(np.arange(10))
    arr = {dev: fleet_arrays(fleet, dev) for dev in ("cpu", DEVICE)}
    t0 = time.perf_counter()
    lam = bl.tune_fedl_lambda_for_constraints(arr[DEVICE], B)
    tune_ms = (time.perf_counter() - t0) * 1e3
    lam_cpu = bl.tune_fedl_lambda_for_constraints(arr["cpu"], B)
    print(f"  tuned λ (24 steps, 120-point grid) = {lam:.6g} on the card in "
          f"{tune_ms:.1f} ms (first call, graph captured), {lam_cpu:.6g} on "
          "the CPU")
    check(math.isclose(lam, lam_cpu, rel_tol=1e-2),
          f"tuned λ {lam} on the card, {lam_cpu} on the CPU")
    out = {}
    for label, ref in (("sao", "sao"), ("sao:box", "sao:box"),
                       ("equal", "equal"),
                       ("fedl at the tuned λ", {"name": "fedl",
                                                 "params": {"lam": lam}}),
                       ("fedl:4.58", "fedl:4.58"), ("fedl:1000", "fedl:1000"),
                       ("fedl_auto", "fedl_auto")):
        alloc = ALLOCATORS.resolve(ref)
        name = alloc.registry_name

        def call(alloc=alloc):
            return alloc.allocate(arr[DEVICE], B)

        first_ms, _ = host_ms(torch, call, reps=1)
        ms, a = host_ms(torch, call)
        launches = device_launches(torch, call)
        c = alloc.allocate(arr["cpu"], B)
        T, E, T_c, E_c = float(a.T), float(a.E), float(c.T), float(c.E)
        r = dict(T=T, E=E, T_cpu=T_c, E_cpu=E_c, ms=ms, first_ms=first_ms,
                 device_launches_per_call=launches)
        tol = ALLOC_TOL[name]
        ok = (math.isclose(T, T_c, rel_tol=tol)
              and math.isclose(E, E_c, rel_tol=tol))
        if name == "fedl":
            r["objective"] = E + alloc.lam * T
            ok = ok and math.isclose(r["objective"], E_c + alloc.lam * T_c,
                                     rel_tol=FEDL_OBJ_TOL)
        print(f"  {label}: T={T:.6f} s E={E:.6f} J (CPU: {T_c:.6f} s, "
              f"{E_c:.6f} J; rtol {tol}: {'ok' if ok else 'FAIL'}) "
              f"ms/call={ms:.1f} (first call {first_ms:.1f}) "
              f"device_launches/call={launches}")
        check(ok, f"{label}: the card's allocation differs from the CPU's")
        out[label] = r

    # the graphs against their bodies run eagerly on the card
    with eager_solves():
        sao_eager = {}
        for box in (False, True):
            def sao(box=box):
                return solve_sao(arr[DEVICE], B, box_correct=box)
            sao_ms, sol = host_ms(torch, sao, reps=1)
            sao_eager[box] = dict(ms=sao_ms, sol=sol,
                                  launches=device_launches(torch, sao))
        ms, e = host_ms(torch, lambda: bl.fedl_lambda(arr[DEVICE], B, 4.58),
                        reps=1)
        launches = device_launches(
            torch, lambda: bl.fedl_lambda(arr[DEVICE], B, 4.58))
        auto_ms, ea = host_ms(torch, lambda: ALLOCATORS.resolve(
            "fedl_auto").allocate(arr[DEVICE], B), reps=1)
    for box, label in ((False, "sao"), (True, "sao:box")):
        graph_sol = solve_sao(arr[DEVICE], B, box_correct=box)
        eager = sao_eager[box]
        same = all(torch.equal(x, y) for x, y in zip(graph_sol, eager["sol"]))
        out["eager"] = out.get("eager", {})
        out["eager"][label] = dict(ms=eager["ms"],
                                   device_launches_per_call=eager["launches"],
                                   bit_equal_graph=same)
        print(f"  {label}: graph ms/call={out[label]['ms']:.1f} "
              f"(first call {out[label]['first_ms']:.1f}) "
              f"device_launches/call={out[label]['device_launches_per_call']}"
              f"; eager ms/call={eager['ms']:.1f} device_launches/call="
              f"{eager['launches']}; graph and eager bit for bit: "
              f"{'equal' if same else 'DIFFER'}")
        check(same, f"{label}: SAO's CUDA graph differs from its eager solve")
    g = bl.fedl_lambda(arr[DEVICE], B, 4.58)
    ga = ALLOCATORS.resolve("fedl_auto").allocate(arr[DEVICE], B)
    err = max(float((x - y).abs().max()) for x, y in zip(g[:4], e[:4]))
    err_auto = max(abs(float(ga.T) - float(ea.T)), abs(float(ga.E)
                                                       - float(ea.E)))
    out["eager"]["fedl:4.58"] = dict(ms=ms, device_launches_per_call=launches,
                                     max_abs_diff_graph=err)
    out["eager"]["fedl_auto"] = dict(ms=auto_ms, max_abs_diff_graph=err_auto)
    print(f"  eager on the card: fedl:4.58 ms/call={ms:.1f} "
          f"device_launches/call={launches} (graph − eager max abs "
          f"{err:.3e}); fedl_auto ms/call={auto_ms:.1f} (graph − eager T, E "
          f"max abs {err_auto:.3e}); graph ms/call "
          f"{out['fedl:4.58']['ms']:.1f} and {out['fedl_auto']['ms']:.1f}")
    obj = lambda r: float(torch.sum(r.e) + 4.58 * r.T)   # noqa: E731
    check(math.isclose(obj(g), obj(e), rel_tol=FEDL_OBJ_TOL)
          and math.isclose(float(ga.T), float(ea.T), rel_tol=ALLOC_TOL["fedl"])
          and math.isclose(float(ga.E), float(ea.E),
                           rel_tol=ALLOC_TOL["fedl"]),
          "FEDL's CUDA graph differs from its eager solve")

    # the figure's assertions
    sao = solve_sao(arr[DEVICE], B)
    eq = bl.equal_bandwidth(arr[DEVICE], B)
    both = bool(sao.converged) and bool(eq.feasible.all())
    if both:
        check(out["sao"]["T"] <= out["equal"]["T"] * 1.02,
              "SAO must beat equal bandwidth (Fig. 5)")
    fedl_f = bl.fedl_lambda(arr[DEVICE], B, lam)
    n_violate = int((fedl_f.e > arr[DEVICE]["e_cons"] + 1e-6).sum())
    verdict = ("both feasible: ≤ 1.02 checked" if both
               else "not both feasible: not checked")
    print(f"  Fig. 5: SAO T / equal T = "
          f"{out['sao']['T'] / out['equal']['T']:.4f} ({verdict}); devices "
          f"over budget at the tuned λ: {n_violate}")
    check(n_violate == 0, f"{n_violate} devices over their energy budget at "
                          "the tuned λ")
    out["tuned_lambda"] = lam
    out["tune_ms"] = tune_ms
    return out


def power_phase(torch):
    """(b) Algorithm 6 on the card, on ``tests/test_power.py``'s fleet:
    T* within 5 % of the better endpoint."""
    import numpy as np
    from repro_torch.core.power import optimal_transmit_power
    from repro_torch.core.sao import solve_sao
    from repro_torch.core.wireless import (dbm_to_watt, fleet_arrays,
                                           sample_fleet)
    fleet = sample_fleet(100, seed=0, e_cons_range=(35e-3, 35e-3)).select(
        np.arange(10))
    t0 = time.perf_counter()
    res = optimal_transmit_power(fleet, 20.0, p_min_dbm=10, p_max_dbm=23,
                                 device=DEVICE)
    ms = (time.perf_counter() - t0) * 1e3
    ends = [float(solve_sao(fleet_arrays(fleet.with_power(dbm_to_watt(p)),
                                         DEVICE), 20.0).T) for p in (10, 23)]
    print(f"  Algorithm 6: p*={res.p_star_dbm:.3f} dBm T*={res.T_star:.6f} s "
          f"after {len(res.history)} probes in {ms:.1f} ms; endpoints T = "
          f"{ends[0]:.6f} (10 dBm), {ends[1]:.6f} s (23 dBm)")
    check(res.T_star <= min(ends) * 1.05,
          "Algorithm 6: T* above 1.05 × the better endpoint")
    check(10.0 <= res.p_star_dbm <= 23.01, "Algorithm 6: p* outside the box")
    return dict(p_star_dbm=res.p_star_dbm, T_star=res.T_star,
                probes=len(res.history), ms=ms)


COMPARISON_ROUNDS = ([(s, "sao") for s in ("divergence", "kmeans_random",
                                           "random", "icas", "rra",
                                           "stochastic-sched")]
                     + [("divergence", a) for a in ("equal", "sao:box",
                                                    "fedl_auto")])


def comparison_rounds_phase(torch):
    """(c) ``build_experiment(ExperimentSpec())`` on the card: the initial
    round, then one ``round(method)`` per (selector, allocator) of
    ``COMPARISON_ROUNDS``, the allocator swapped in between rounds. Each
    round's set, T_k and E_k are checked (and SAO's band use under
    ``sao``); its ms by phase come from timing wrappers around the
    experiment's own ``select`` and its allocator's ``allocate_traced``
    (a device sync after each), the rest of the round being train, fold
    and evaluation. The FL kernels' counts are set to 0 just before and
    read just after."""
    from repro_torch.api import ALLOCATORS, ExperimentSpec, build_experiment

    exp = build_experiment(ExperimentSpec(), device=DEVICE)
    need = least_band_mhz(exp.fleet)
    fns = kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    exp.initial_round()
    torch.cuda.synchronize()
    print(f"  initial round {(time.perf_counter() - t0) * 1e3:.1f} ms")
    laps = {}

    def timed(name, fn):
        def wrapper(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            laps[name] = (time.perf_counter() - t) * 1e3
            return out
        return wrapper

    class TimedAllocator:
        """The allocator, its ``allocate_traced`` (what the round body
        calls) timed."""
        def __init__(self, inner):
            self.inner = inner
            self.allocate_traced = timed("allocate", inner.allocate_traced)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    exp.select = timed("select", exp.select)
    out = []
    n = exp.fed.num_clients
    for k, (selection, allocator) in enumerate(COMPARISON_ROUNDS):
        exp.allocator = TimedAllocator(ALLOCATORS.resolve(allocator))
        t0 = time.perf_counter()
        res = exp.round(selection)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        sel = [int(i) for i in res.selected]
        what = f"round {k + 1} ({selection}, {allocator})"
        check(0 < len(sel) <= n and len(set(sel)) == len(sel)
              and all(0 <= i < n for i in sel), f"{what}: bad selection {sel}")
        check(math.isfinite(res.T_k) and res.T_k > 0
              and math.isfinite(res.E_k) and res.E_k > 0,
              f"{what}: T_k={res.T_k}, E_k={res.E_k}")
        rest = wall - laps["select"] - laps["allocate"]
        print(f"  {what}: {len(sel)} selected {sel} T_k={res.T_k:.6f} s "
              f"E_k={res.E_k:.6f} J accuracy={res.accuracy:.4f}; ms: round "
              f"{wall:.1f} = select {laps['select']:.1f} + allocate "
              f"{laps['allocate']:.1f} + train/fold/evaluate {rest:.1f}")
        if allocator == "sao":
            check_sao_band(exp, need, what, res.selected, res.band_mhz)
        out.append(dict(selection=selection, allocator=allocator,
                        selected=sel, T_k=res.T_k, E_k=res.E_k, ms=wall,
                        select_ms=laps["select"],
                        allocate_ms=laps["allocate"]))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in fns.items()}
    print(f"  launches in this run: {launches}")
    for name in ("flat_aggregate", "pairwise_l2"):
        check(launches[name] > 0, f"{name} was not launched on this path")
    return out, launches


def varying_set_phase(torch, rounds=5):
    """(d) ``ExperimentSpec(selection="rra")``: the initial round and
    ``rounds`` host-loop rounds, whose set size changes from round to
    round, once with the solves' CUDA graphs (a graph per set size from
    its second solve on) and once with every solve eager, from one seed:
    the histories must be equal. Per-round wall for both, and the graphs
    held and device memory reserved after the graphed run."""
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.core import baselines, sao
    from repro_torch.core.graphs import eager_solves

    spec = ExperimentSpec(selection="rra")
    out = {}
    for label in ("graphs", "eager"):
        sao._GRAPHS.clear()
        baselines._GRAPHS.clear()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        exp = build_experiment(spec, device=DEVICE)
        if label == "eager":
            with eager_solves():
                hist = exp.run(rounds=rounds)
        else:
            hist = exp.run(rounds=rounds)
        torch.cuda.synchronize()
        check(len(hist.seconds) == rounds + 1, "rra did not take the host "
                                               "loop")
        out[label] = dict(hist=hist, graphs=len(sao._GRAPHS.graphs),
                          reserved_mib=(torch.cuda.memory_reserved()
                                        - reserved) / 2**20)
        print(f"  rra, {label}: set sizes "
              f"{[len(x) for x in hist.selected[1:]]}; wall ms a round "
              f"{[round(t * 1e3, 1) for t in hist.seconds[1:]]} (initial "
              f"round {hist.seconds[0] * 1e3:.1f}); SAO graphs held "
              f"{out[label]['graphs']}; device memory reserved "
              f"+{out[label]['reserved_mib']:.1f} MiB")
        del exp
    g, e = out["graphs"]["hist"], out["eager"]["hist"]
    same = (all(a.tolist() == b.tolist()
                for a, b in zip(g.selected, e.selected))
            and g.T_k == e.T_k and g.E_k == e.E_k
            and g.accuracy == e.accuracy)
    print(f"  rra with graphs and eager: histories "
          f"{'equal' if same else 'DIFFER'}; total wall ms "
          f"{sum(g.seconds) * 1e3:.1f} with graphs, "
          f"{sum(e.seconds) * 1e3:.1f} eager")
    check(same, "rra: the graphed run differs from the eager one")
    return {k: dict(seconds=v["hist"].seconds, graphs=v["graphs"],
                    reserved_mib=v["reserved_mib"]) for k, v in out.items()}


MARK_BURSTS, MARK_SPINS, MARK_GAP_S = 40, 16, 0.005
CALL_MARK_BURSTS = 10            # around one kernel call (phases 2, 7)


def mark(torch, bursts=MARK_BURSTS):
    """Marker device work around a profiled call: ``bursts`` bursts of
    ``MARK_SPINS`` short spin kernels, each burst synced and followed by
    ``MARK_GAP_S`` of host sleep, about 0.2 s in all for ``MARK_BURSTS``.
    The profiler drops the device records of a session's first moments (13
    to 16 of 64 spins enqueued back to back were lost in some runs, all 64
    in another), so what it drops must be marks spread over time, not the
    call's records."""
    for _ in range(bursts):
        for _ in range(MARK_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(MARK_GAP_S)


def profiled_device_work(torch, fn, what, bursts=MARK_BURSTS):
    """``fn`` under ``torch.profiler``, between two runs of ``mark``
    (``bursts`` bursts each): its device work (kernels, copies, memsets; a
    replayed graph gives each of its kernels) from the raw event list as
    ``(name, ms)`` pairs, how many marks were recorded before its first
    record and after its last, and its own device window [ms]: from its
    first record's start to its last record's end. Fails when either side
    kept none: the profiler's window may then have cut ``fn``'s own
    records. The device activity only: the host's op records of an eager
    round (several per kernel) made a profiled cohort run's stop and read
    ≈ 5× the run itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mark(torch, bursts)
        fn()
        torch.cuda.synchronize()
        mark(torch, bursts)
    work, marks = [], []
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
        if "spin_kernel" in name:
            marks.append(e.start_ns())
        else:
            work.append((e.start_ns(), name, e.duration_ns() / 1e6))
    first = min((t for t, _, _ in work), default=math.inf)
    last = max((t for t, _, _ in work), default=-math.inf)
    end = max((t + ms * 1e6 for t, _, ms in work), default=-math.inf)
    before = sum(t < first for t in marks)
    after = sum(t > last for t in marks)
    check(before > 0 and after > 0,
          f"the profiler kept {before} marks before {what} and {after} after "
          f"it (of {bursts * MARK_SPINS} each): its window may have cut "
          f"{what}'s own records")
    return ([(name, ms) for _, name, ms in work], before, after,
            (end - first) / 1e6)


def idle_share(busy_ms, window_ms):
    """The share of a profiled call's own device window (its first
    record's start to its last record's end) in which none of its device
    work ran: the gaps between a replay's kernels. Read from the same
    profiled call as ``busy_ms``, so it lies in [0, 1) (a graph captured
    from one stream runs its kernels one at a time)."""
    return 1.0 - busy_ms / window_ms


def profile_replay(torch, prog, batch, draw=None, fade=None, churn=None,
                   fault=None):
    """One replay of ``prog``'s captured round under ``torch.profiler``
    (``profiled_device_work``): its device launches, busy ms, the launches
    of each FL kernel and of each device function, the marks kept before
    and after it, and its own device window [ms]."""
    from collections import defaultdict
    prog.replay(batch, draw, fade, churn, fault)
    work, before, after, window = profiled_device_work(
        torch, lambda: prog.replay(batch, draw, fade, churn, fault),
        "the replay")
    by_name = defaultdict(lambda: [0, 0.0])
    for name, ms in work:
        by_name[name][0] += 1
        by_name[name][1] += ms
    kernels = {k: sum(n for name, (n, _) in by_name.items()
                      if f"{k}_kernel" in name)
               for k in ("flat_aggregate", "pairwise_l2")}
    return (len(work), sum(ms for _, ms in work), kernels, by_name,
            (before, after), window)


# each kernel's own device function: one launch of it per wrapper call
DEVICE_KERNEL = {"flat_aggregate": "flat_aggregate_kernel",
                 "pairwise_l2": "pairwise_l2_kernel",
                 "flash_attention": "flash_kernel",
                 "ssd_scan": "ssd_chunk_kernel"}


def profiled_kernel_counts(torch, fn):
    """``fn`` under ``torch.profiler`` (``profiled_device_work``): the
    device launches of each kernel's own function (``DEVICE_KERNEL``) and
    of ``slab_sum_kernel`` in it, and the marks kept before and after."""
    work, before, after, _ = profiled_device_work(torch, fn, "the run")
    names = dict(DEVICE_KERNEL, slab_sum="slab_sum_kernel")
    counts = {k: sum(fn_name in name for name, _ in work)
              for k, fn_name in names.items()}
    return counts, (before, after)


def path_launches(torch, fns, run, rounds, what):
    """A device-resident path's launches of each kernel: ``run`` (the
    initial round and ``rounds`` replays of an already captured round)
    under ``torch.profiler``, with the wrappers' counts set to 0 just
    before it and read just after. The wrappers count the (eager) initial
    round's launches only, as a replay counts nothing, so the profiled
    counts are the path's. Returns them with the wrappers' counts; the
    caller holds them to the initial round's + ``rounds`` × one replay's
    (``hold_path_launches``)."""
    torch.cuda.synchronize()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    run_counts, kept = profiled_kernel_counts(torch, run)
    wrapped = {name: fn.launches for name, fn in fns.items()}
    print(f"  {what}: a profiled run (initial round + {rounds} replays; marks "
          f"kept before and after it: {kept[0]} and {kept[1]} of "
          f"{MARK_BURSTS * MARK_SPINS}; {time.perf_counter() - t0:.1f} s "
          f"with the profiler's stop and read): device launches "
          f"{run_counts}; the wrappers counted {wrapped} in its initial "
          f"round")
    return {name: run_counts[name] for name in KERNELS}, wrapped


def hold_path_launches(launches, wrapped, inside, rounds, what,
                       replayed=("flat_aggregate", "pairwise_l2")):
    """Fail unless each kernel's launches in a profiled run are its
    initial round's (the wrappers') + ``rounds`` × one profiled replay's
    (``inside``), and each kernel of ``replayed`` ran in every replay (a
    selector with no divergence replays no ``pairwise_l2``)."""
    expect = {name: wrapped[name] + rounds * inside.get(name, 0)
              for name in KERNELS}
    print(f"  {what}: the initial round + {rounds} x one replay's {inside} "
          f"make {expect}: {'agree' if expect == launches else 'DIFFER'}")
    check(expect == launches, f"{what}: {launches} device launches in the "
                              f"profiled run, not {expect}")
    for name in replayed:
        check(inside[name] > 0,
              f"{what}: {name} did not run inside the replayed round")


def single_program(exp):
    """The device-resident program of ``exp``'s own bundle and shapes (the
    one its ``run()`` captured and replays)."""
    from repro_torch.core import engine
    return engine.run_rounds(
        exp.engine_cfg, selector=exp.selector, allocator=exp.allocator,
        aggregator=exp.aggregator, tctx=exp.traced_context(),
        feature_layer=exp.fl.feature_layer, device=exp.device,
        shapes=exp.traced_inputs().shapes(), base=exp.base,
        compressor=exp.compressor, channel=exp.channel, churn=exp.churn,
        **exp._fault_args())


def traced_phase(torch, rounds=5):
    """The device-resident run of ``ExperimentSpec()`` against its host loop
    from the same seed: the initial round and ``rounds`` rounds each. The
    traced run goes through ``run()`` (its first call captures the round);
    a second traced run replays the cached graph with PyTorch's sync debug
    mode on, counting host syncs from the initial round to the last
    replay. Then the replayed round's ms, and one replay profiled."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment

    spec = ExperimentSpec()
    fns = kernel_fns()
    host = build_experiment(spec, device=DEVICE)
    traced = build_experiment(spec, device=DEVICE)
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    h_t = traced.run(rounds=rounds)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counted = {name: fn.launches for name, fn in fns.items()}
    check(h_t.seconds == [], "run() did not take the device-resident path")
    h_h = host._run_host(None, rounds, 0.0)
    torch.cuda.synchronize()

    for k, (a, b) in enumerate(zip(h_t.selected, h_h.selected)):
        check(np.array_equal(a, b), f"round {k}: traced selected {list(a)}, "
                                    f"host loop {list(b)}")
        if k:
            check(len(a) == spec.devices_per_round,
                  f"round {k}: {len(a)} selected, not a full selection")
    d_T = max(abs(x - y) / abs(y) for x, y in zip(h_t.T_k, h_h.T_k))
    d_E = max(abs(x - y) / abs(y) for x, y in zip(h_t.E_k, h_h.E_k))
    d_acc = max(abs(x - y) for x, y in zip(h_t.accuracy, h_h.accuracy))
    d_row = float((traced.global_vec - host.global_vec).abs().max())
    d_plane = float((traced.client_plane - host.client_plane).abs().max())
    for k in range(len(h_t.accuracy)):
        print(f"  round {k}: accuracy={h_t.accuracy[k]:.4f} "
              f"T_k={h_t.T_k[k]:.6f} s E_k={h_t.E_k[k]:.6f} J "
              f"band={h_t.band_mhz[k]:.4f} MHz "
              f"selected={list(map(int, h_t.selected[k]))}")
    print(f"  traced vs host loop: selections equal; max rel diff T_k "
          f"{d_T:.3e}, E_k {d_E:.3e} (tol 1e-6); accuracy max diff "
          f"{d_acc:.3e} (must be 0); global row max abs diff {d_row:.3e} "
          f"(tol 1e-5); client plane {d_plane:.3e}")
    check(d_T <= 1e-6 and d_E <= 1e-6, "traced T_k/E_k differ from the host "
                                       "loop's")
    check(d_acc == 0.0, "traced accuracy differs from the host loop's")
    check(d_row <= 1e-5, f"traced global row differs by {d_row}")
    check(bool(torch.isfinite(traced.global_vec).all()), "non-finite row")

    prog = single_program(traced)
    check(prog.graph is not None, "the round was not captured")
    # a second run on a fresh experiment (the graph cached): host syncs
    # from the initial round to the last replay, and its wall
    again = build_experiment(spec, device=DEVICE)
    state, inputs = again.traced_state(), again.traced_inputs()
    torch.cuda.synchronize()
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = prog(state, *inputs, draws=again.draws, rounds=rounds,
                       with_init=True)
            enqueue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    second_ms = (time.perf_counter() - t0) * 1e3
    # a replay counts nothing: these are the initial round's launches
    init_counts = {name: fn.launches for name, fn in fns.items()}
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()]
    acc2 = res.rounds.accuracy.cpu().tolist()
    check(acc2 == h_t.accuracy[1:], "a second traced run from the same seed "
                                    "gave other accuracies")
    print(f"  first traced run (initial round + {rounds}, capture included) "
          f"{first_ms:.1f} ms; capture {prog.capture_ms:.1f} ms; a second "
          f"run from the same seed (graph cached) {second_ms:.1f} ms, "
          f"{enqueue_ms:.1f} ms of it enqueueing; host syncs in it: "
          f"{len(syncs)}{' ' + syncs[0][:120] if syncs else ''}")
    check(not syncs, "the traced run waited for the card before its end")

    batch = again.draws.batch_indices(prog.pad, spec.local_iters,
                                      spec.batch_size, spec.samples_per_client)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.replay(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    replay_ms = sorted(walls)[len(walls) // 2]
    host_round_ms = sorted(h_h.seconds[1:])[len(h_h.seconds[1:]) // 2] * 1e3
    n_dev, busy, inside, by_name, kept, window = profile_replay(
        torch, prog, batch)
    print(f"  round wall (host clock, synchronised; median): traced replay "
          f"{replay_ms:.1f} ms, host loop {host_round_ms:.1f} ms "
          f"({host_round_ms / replay_ms:.2f}x)")
    print(f"  one profiled replay: {n_dev} device launches, {busy:.2f} ms busy"
          f" in its own device window of {window:.2f} ms: idle share "
          f"{idle_share(busy, window):.4f}; "
          f"inside it: {inside}; the wrappers counted "
          f"{ {k: (counted[k] - init_counts[k]) // 2 for k in inside} } a "
          f"round at the warm-up and the capture (marks kept before and "
          f"after it: {kept[0]} and {kept[1]} of {MARK_BURSTS * MARK_SPINS})")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for i, (name, (n, t)) in enumerate(ranked[:6]):
        print(f"  kernel #{i + 1} {name[:72]}: {n} launches, {t:.3f} ms")

    # the path's launch counts: a third run from the same seed, the
    # initial round and all its replays under the profiler
    third = build_experiment(spec, device=DEVICE)
    state, inputs = third.traced_state(), third.traced_inputs()
    launches, wrapped = path_launches(torch, fns, lambda: prog(
        state, *inputs, draws=third.draws, rounds=rounds, with_init=True),
        rounds, "the device-resident path")
    hold_path_launches(launches, wrapped, inside, rounds,
                       "the device-resident path")
    print(f"  the wrappers' counts in the first run (warm-up and capture "
          f"included): {counted}")
    return launches, dict(replay_ms=replay_ms, host_round_ms=host_round_ms,
                          capture_ms=prog.capture_ms, device_launches=n_dev,
                          busy_ms=busy, window_ms=window, inside=inside)


# benchmarks/common.py's BENCH_DEFAULTS (the figures' §VI protocol), kept
# here: the port imports nothing of the benchmarks
FIG10_DEFAULTS = dict(dataset="fashion", train_samples=2500,
                      test_samples=600, samples_per_client=96, sigma=0.8,
                      local_iters=20, learning_rate=0.08, num_clusters=10,
                      devices_per_round=10, data_seed=7, seed=0)
FIG10_METHODS = ("divergence", "kmeans_random", "random", "icas")
FIG10_TARGET = 0.60                 # fashion's rounds-to-target accuracy
LANE_TOL = dict(T_E=1e-5, row=1e-5)  # a lane against its seed's single run


def lane_vs_single(ch, i, lane, single, h_single, what, test_samples):
    """Lane ``i`` of the cohort history ``ch`` (its experiment ``lane``)
    against its seed's single run (``single``, history ``h_single``):
    selections equal, accuracy within one test sample, T_k and E_k within
    rtol 1e-5, the final global row within atol 1e-5."""
    import numpy as np
    hi = ch.history(i)
    check(len(hi.selected) == len(h_single.selected),
          f"{what}: {len(hi.selected)} rounds, the single run "
          f"{len(h_single.selected)}")
    for k, (a, b) in enumerate(zip(hi.selected, h_single.selected)):
        check(np.array_equal(a, b), f"{what}: round {k} selected {list(a)}, "
                                    f"its single run {list(b)}")
    d_T = max(abs(x - y) / abs(y) for x, y in zip(hi.T_k, h_single.T_k))
    d_E = max(abs(x - y) / abs(y) for x, y in zip(hi.E_k, h_single.E_k))
    d_acc = max(abs(x - y) for x, y in zip(hi.accuracy, h_single.accuracy))
    d_row = float((lane.global_vec - single.global_vec).abs().max())
    check(d_T <= LANE_TOL["T_E"] and d_E <= LANE_TOL["T_E"],
          f"{what}: T_k/E_k differ from the single run by {d_T}, {d_E}")
    check(d_acc <= 1.0 / test_samples + 1e-9,
          f"{what}: accuracy differs from the single run by {d_acc}")
    check(d_row <= LANE_TOL["row"], f"{what}: global row differs by {d_row}")
    return d_T, d_E, d_acc, d_row


def lane_draws(torch, prog, exps):
    """A round's batch indices and selector draw (``None`` for a
    deterministic selector) for ``prog``'s lanes, from each lane's
    experiment's draws: lane-stacked for a cohort, else ``exps[0]``'s."""
    spec = exps[0].spec
    batch = [e.draws.batch_indices(prog.pad, spec.local_iters,
                                   spec.batch_size, spec.samples_per_client)
             for e in exps]
    draw = [e.draws.selector_draw(prog.draw_kind, spec.clients)
            for e in exps] if prog.draw_kind else None
    if prog.lanes is None:
        return batch[0], draw and draw[0]
    return torch.stack(batch), draw and torch.stack(draw)


def profiled_cohort_run(torch, fns, runner, rounds, what):
    """A cohort run from the same seeds as ``runner``'s last, its program
    already captured: under ``transfer_guard`` (sync debug mode "error":
    any host sync raises) and under the profiler (``path_launches``).
    Returns the history, its wall [ms] (the profiler's included), the
    path's launches and the wrappers' counts (the initial round's)."""
    out = {}

    def run():
        t0 = time.perf_counter()
        out["ch"] = runner.run(rounds=rounds, transfer_guard=True)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
    launches, wrapped = path_launches(torch, fns, run, rounds, what)
    return out["ch"], out["ms"], launches, wrapped


def same_history(a, b):
    """Two cohort histories equal in every round of every lane."""
    import numpy as np
    return (np.array_equal(a.selected, b.selected)
            and a.accuracy.tolist() == b.accuracy.tolist()
            and a.T_k.tolist() == b.T_k.tolist()
            and a.E_k.tolist() == b.E_k.tolist())


def cohort_phase(torch, rounds=3, lanes=8):
    """(a) ``build_cohort(ExperimentSpec(cohort=8))``: the initial round and
    ``rounds`` replays of ONE captured round for the 8 lanes. A first run
    captures; a second from the same seeds runs under ``transfer_guard``
    (any host sync raises) and under the profiler, the wrappers' counts
    set to 0 just before it and read just after: its device launches are
    the path's, held to the initial round's + ``rounds`` × one profiled
    replay's. It must repeat the first. Each lane is held to its seed's
    single traced run. Then the cohort's replay against the single run's
    (median of 6 synchronised replays each, in turns), one cohort replay
    profiled (device launches, idle share of its own device window, the
    FL kernels inside) and the device memory."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_cohort, build_experiment

    what = f"cohort of {lanes}"
    spec = ExperimentSpec(cohort=lanes)
    fns = kernel_fns()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    runner = build_cohort(spec)
    build_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    first = runner.run(rounds=rounds)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    prog = runner.program
    check(prog.graph is not None and prog.lanes == lanes,
          "the cohort's round was not captured as one graph for all lanes")
    ch, guarded_ms, launches, wrapped = profiled_cohort_run(
        torch, fns, runner, rounds, what)
    check(runner.program is prog, "the second cohort run captured again")
    check(ch.accuracy.shape == (lanes, rounds + 1)
          and bool(np.isfinite(ch.accuracy).all()
                   and np.isfinite(ch.T_k).all()
                   and np.isfinite(ch.E_k).all()),
          f"cohort history: shape {ch.accuracy.shape} or non-finite values")
    check(same_history(first, ch), "two cohort runs from the same seeds differ")
    print(f"  {what} (seeds {ch.seeds}): build {build_ms:.1f} ms; first run "
          f"(initial round + {rounds}, capture included) {first_ms:.1f} ms, "
          f"capture {prog.capture_ms:.1f} ms; a second run under "
          f"transfer_guard (sync debug mode 'error': 0 host syncs) and the "
          f"profiler {guarded_ms:.1f} ms, equal to the first")
    print(f"  final accuracy by lane "
          f"{[round(float(a), 4) for a in ch.final_accuracy]}")

    worst = np.zeros(4)
    for i, seed in enumerate(ch.seeds):
        single = build_experiment(spec.replace(seed=seed))
        h = single.run(rounds=rounds)
        check(h.seconds == [], "a single run did not take the traced path")
        worst = np.maximum(worst, lane_vs_single(
            ch, i, runner.experiments[i], single, h,
            f"cohort lane {i} (seed {seed})", spec.test_samples))
    print(f"  every lane against its seed's single traced run: selections "
          f"equal; max rel diff T_k {worst[0]:.3e}, E_k {worst[1]:.3e} (tol "
          f"1e-5); accuracy max diff {worst[2]:.4f} (tol one test sample, "
          f"{1 / spec.test_samples}); global row max abs diff "
          f"{worst[3]:.3e} (tol 1e-5)")

    single_prog = single_program(single)
    e0 = runner.experiments[0]
    batch, _ = lane_draws(torch, prog, runner.experiments)
    batch1, _ = lane_draws(torch, single_prog, [single])
    walls = {"single": [], "cohort": []}
    for _ in range(3):
        for name, fn in (("single", lambda: single_prog.replay(batch1)),
                         ("cohort", lambda: prog.replay(batch)),
                         ("cohort", lambda: prog.replay(batch)),
                         ("single", lambda: single_prog.replay(batch1))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    ms = {k: float(np.median(v)) for k, v in walls.items()}
    n_dev, busy, inside, by_name, kept, window = profile_replay(
        torch, prog, batch)
    n1, busy1, _, _, _, window1 = profile_replay(torch, single_prog, batch1)
    reserved = (torch.cuda.memory_reserved() - reserved0) / 2**20
    peak = torch.cuda.max_memory_allocated() / 2**20
    plane_mb = lanes * (spec.clients + prog.pad) * e0.global_vec.numel() * 4
    print(f"  replay wall (host clock, synchronised; median of "
          f"{len(walls['cohort'])}, in turns): {what} {ms['cohort']:.1f} ms, "
          f"one seed {ms['single']:.1f} ms "
          f"({ms['cohort'] / ms['single']:.2f}x for {lanes}x the seeds)")
    print(f"  one profiled cohort replay: {n_dev} device launches (one seed's:"
          f" {n1}), {busy:.2f} ms busy in its own device window of "
          f"{window:.2f} ms: idle share {idle_share(busy, window):.4f} (one "
          f"seed's: {busy1:.2f} of {window1:.2f} ms, "
          f"{idle_share(busy1, window1):.4f}); inside it: {inside} (marks "
          f"kept before and after it: {kept[0]} and {kept[1]})")
    for i, (name, (n, t)) in enumerate(sorted(by_name.items(),
                                              key=lambda kv: -kv[1][1])[:5]):
        print(f"  kernel #{i + 1} {name[:72]}: {n} launches, {t:.3f} ms")
    print(f"  device memory: reserved +{reserved:.1f} MiB over the phase, "
          f"peak allocated {peak:.1f} MiB; the [{lanes}, "
          f"{spec.clients + prog.pad}, {e0.global_vec.numel()}] plane "
          f"{plane_mb / 1e6:.1f} MB")
    hold_path_launches(launches, wrapped, inside, rounds, what)
    return launches, dict(replay_ms=ms["cohort"], single_replay_ms=ms["single"],
                          capture_ms=prog.capture_ms, device_launches=n_dev,
                          busy_ms=busy, window_ms=window,
                          reserved_mib=reserved, peak_mib=peak)


def stochastic_cohort_phase(torch, rounds=2, lanes=4):
    """(b) Cohorts of 4 seeds under ``kmeans_random`` and ``random``, each
    lane's selector draws from its own draws object. A first run
    captures; a second from the same seeds runs under ``transfer_guard``
    and the profiler (``profiled_cohort_run``: the path's launches, held
    to the initial round's + ``rounds`` × one profiled replay's) and must
    repeat it. At most s devices of a cluster (``kmeans_random``), exactly
    S distinct (``random``), and the last lane equal to its seed's single
    traced run fed the same draws (``traced_run(..., draws=)``). Returns
    each selector's path launches."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_cohort, build_experiment
    fns = kernel_fns()
    by_selector = {}
    for selection in ("kmeans_random", "random"):
        what = f"{selection}, cohort of {lanes}"
        spec = ExperimentSpec(cohort=lanes, selection=selection)
        t0 = time.perf_counter()
        runner = build_cohort(spec)
        first = runner.run(rounds=rounds)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        prog = runner.program
        ch, guarded_ms, launches, wrapped = profiled_cohort_run(
            torch, fns, runner, rounds, what)
        check(runner.program is prog and same_history(first, ch),
              f"{what}: a second run from the same seeds differs or "
              "captured again")
        sizes = []
        for i in range(lanes):
            labels = runner.experiments[i].cluster_labels
            for k, sel in enumerate(ch.history(i).selected[1:]):
                where = f"{selection} lane {i} round {k + 1}"
                check(len(set(sel.tolist())) == len(sel)
                      and all(0 <= d < spec.clients for d in sel),
                      f"{where}: bad selection {list(sel)}")
                if selection == "random":
                    check(len(sel) == spec.devices_per_round,
                          f"{where}: {len(sel)} devices, not S")
                else:
                    check(np.bincount(labels[sel]).max()
                          <= spec.selected_per_cluster,
                          f"{where}: more than s devices of a cluster")
                sizes.append(len(sel))
        i = lanes - 1
        single = build_experiment(spec.replace(seed=ch.seeds[i]))
        res = single.traced_run(single.selector, rounds, draws=single.draws)
        h = single.history_from_traced(res, spec.clients)
        single.load_traced_state(res.state)
        d = lane_vs_single(ch, i, runner.experiments[i], single, h,
                           f"{selection} lane {i}", spec.test_samples)
        batch, draw = lane_draws(torch, prog, runner.experiments)
        inside = profile_replay(torch, prog, batch, draw)[2]
        # neither selector reads the divergence: pairwise_l2 runs in the
        # initial round's K-means only
        hold_path_launches(launches, wrapped, inside, rounds, what,
                           replayed=("flat_aggregate",))
        check(launches["pairwise_l2"] > 0,
              f"{what}: no pairwise_l2 in the initial round's K-means")
        by_selector[selection] = launches
        print(f"  {what}: initial round + {rounds}: first run {first_ms:.1f} "
              f"ms (capture {prog.capture_ms:.1f} ms), a second under "
              f"transfer_guard and the profiler {guarded_ms:.1f} ms, equal "
              f"to it; set sizes {sizes}; lane {i} equals its single traced "
              f"run fed the same draws (max rel diff T_k {d[0]:.3e}, E_k "
              f"{d[1]:.3e}; accuracy {d[2]:.4f}; row {d[3]:.3e})")
    return by_selector


def fig10_phase(torch, rounds=10, seeds=(0, 17)):
    """(c) The quick cell of Fig. 10/11 and Table III
    (``benchmarks/fig10_11_convergence.py``, quick): fashion, σ = 0.8, 30
    clients, 10 rounds, seeds 0 and 17 as one cohort a method. Each
    method's mean final accuracy (at its stop round), median rounds to
    0.60 (rounds + 1 if never), and the Table III score R_random /
    R_divergence − 1. Only the histories are checked (finite, of the right
    shape): two seeds do not establish the paper's ranking."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_cohort
    base = ExperimentSpec(**dict(FIG10_DEFAULTS, clients=30, sigma=0.8,
                                 rounds=rounds, test_seed=90_000,
                                 seed=seeds[0]))
    r2t_median = {}
    for method in FIG10_METHODS:
        t0 = time.perf_counter()
        ch = build_cohort(base.replace(selection=method)).run(
            seeds=list(seeds), rounds=rounds)
        wall = (time.perf_counter() - t0) * 1e3
        check(ch.accuracy.shape == (len(seeds), rounds + 1)
              and bool(np.isfinite(ch.accuracy).all()
                       and np.isfinite(ch.T_k).all()
                       and np.isfinite(ch.E_k).all()),
              f"fig10 {method}: history shape {ch.accuracy.shape} or "
              "non-finite values")
        accs, r2t = [], []
        for i in range(len(seeds)):
            acc = ch.history(i).accuracy
            hit = [k for k, a in enumerate(acc) if a >= FIG10_TARGET]
            accs.append(acc[hit[0] if hit else len(acc) - 1])
            r2t.append(hit[0] if hit else rounds + 1)
        r2t_median[method] = float(np.median(r2t))
        print(f"  fig10/fashion_s0.8_{method}: final accuracy "
              f"{np.mean(accs):.4f} (by seed {[round(a, 4) for a in accs]}); "
              f"rounds to {FIG10_TARGET}: {r2t_median[method]:.1f} (by seed "
              f"{r2t}); curves {np.round(ch.accuracy, 3).tolist()}; "
              f"{wall:.1f} ms for the cohort (build and capture included)")
    score = r2t_median["random"] / max(r2t_median["divergence"], 1e-9) - 1.0
    print(f"  table3/fashion_s0.8 improvement vs FedAvg (R_random / "
          f"R_divergence - 1): {score:.3f} (Favor's published: 0.209; two "
          "seeds, not a ranking)")


# ---------------------------------------------------------------------------
# phase 10: the wireless scenario
# ---------------------------------------------------------------------------


WIRELESS_TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
                     train_samples=160, test_samples=80, local_iters=2,
                     batch_size=8, devices_per_round=4, num_clusters=4,
                     rounds=3)
DYNAMIC_RHO = {"name": "multicell-dynamic", "params": {"rho": 0.9}}


def rows_agree(got, want, atol, what):
    """``got`` within ``atol`` of ``want``, but for the entries an int8
    rounding flipped: a drift below ``atol`` in a trained row moves a
    value across a rounding boundary of the int8 grid now and then, which
    changes it by one quantization step (max|Δ|/127 of its leaf). At most
    0.1 % of the entries may do so, each within 1e-3. Returns the max
    abs diff and how many entries passed ``atol``."""
    d = (got.cpu() - want.cpu()).abs()
    off = int((d > atol).sum())
    err = float(d.max())
    check(off <= 1e-3 * d.numel() and err <= 1e-3,
          f"{what}: {off} of {d.numel()} entries beyond {atol}, max abs "
          f"diff {err}")
    return err, off


def wireless_agreement(torch):
    """(a) Tiny runs on the CPU and on the card from the same draws: a
    2-cell ``multicell-dynamic`` (ρ = 0.9) cohort of one seed with
    ``fedavgm:0.9`` and ``int8``, and a single-cell ``topk:0.01`` run.
    Selections equal, T_k/E_k and ``inr`` within rtol 2e-3, the rows
    within atol 1e-4 (``rows_agree``): phase 3's tolerances."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_cohort, build_experiment
    from repro_torch.api.scenario import multicell_fleet_spec
    spec = ExperimentSpec(**WIRELESS_TINY, cohort=1, aggregator="fedavgm:0.9",
                          compressor="int8",
                          fleet=multicell_fleet_spec(2, channel=DYNAMIC_RHO))
    out = {}
    for dev in ("cpu", DEVICE):
        runner = build_cohort(spec, device=dev,
                              draws=lambda s, dev=dev: _CpuDraws(s, dev))
        out[dev] = runner, runner.run()
    (r_cpu, c_cpu), (r_gpu, c_gpu) = out["cpu"], out[DEVICE]
    check(r_gpu.program.graph is not None and r_gpu.program.lanes == 2,
          "(a) the 2-cell cohort was not one captured round")
    check(np.array_equal(c_cpu.selected * c_cpu.mask,
                         c_gpu.selected * c_gpu.mask),
          f"(a) cells: selections differ, card {c_gpu.selected.tolist()}, "
          f"CPU {c_cpu.selected.tolist()}")
    d = {k: float(np.max(np.abs(getattr(c_gpu, k) / getattr(c_cpu, k) - 1)))
         for k in ("T_k", "E_k", "inr")}
    check(all(v <= 2e-3 for v in d.values()), f"(a) cells: rel diffs {d}")
    errs = [rows_agree(a.global_vec, b.global_vec, 1e-4,
                       f"(a) cell {c} row")
            for c, (a, b) in enumerate(zip(r_gpu.experiments,
                                           r_cpu.experiments))]
    print(f"  (a) 2-cell multicell-dynamic (rho 0.9) cohort, fedavgm:0.9, "
          f"int8, CPU vs card: selections equal; max rel diff {d} (tol "
          f"2e-3); global rows max abs diff {[e for e, _ in errs]}, entries "
          f"beyond 1e-4 (int8 flips) {[n for _, n in errs]}; inr (card) "
          f"{np.round(c_gpu.inr, 4).tolist()}")

    spec = ExperimentSpec(**WIRELESS_TINY, compressor="topk:0.01")
    out = {}
    for dev in ("cpu", DEVICE):
        exp = build_experiment(spec, device=dev, draws=_CpuDraws(0, dev))
        out[dev] = exp, exp.run()
    (e_cpu, h_cpu), (e_gpu, h_gpu) = out["cpu"], out[DEVICE]
    check(h_gpu.seconds == [], "(a) topk: run() did not take the traced path")
    for k, (a, b) in enumerate(zip(h_cpu.selected, h_gpu.selected)):
        check(list(a) == list(b), f"(a) topk: round {k} selected {list(b)} "
                                  f"on the card, {list(a)} on the CPU")
    d = max(abs(x / y - 1) for x, y in zip(h_gpu.T_k + h_gpu.E_k,
                                           h_cpu.T_k + h_cpu.E_k))
    check(d <= 2e-3, f"(a) topk: T_k/E_k differ by {d}")
    err = float((e_gpu.global_vec.cpu() - e_cpu.global_vec).abs().max())
    check(err <= 1e-4, f"(a) topk: global row differs by {err}")
    print(f"  (a) topk:0.01, CPU vs card: selections equal; T_k/E_k max rel "
          f"diff {d:.3e} (tol 2e-3); global row max abs diff {err:.3e} (tol "
          f"1e-4)")


def cells_cohort_phase(torch, rounds=3, seeds=2, cells=3):
    """(b) ``ExperimentSpec(cohort=2, aggregator="fedavgm:0.9",
    compressor="int8", fleet=multicell_fleet_spec(3, channel=
    multicell-dynamic with ρ = 0.9))`` at full width: the paper CNN, 40
    clients a cell, S = 10, L = 20, batch 32 — 6 lanes of ONE captured
    round, the initial round and ``rounds`` replays. A first run captures;
    a second from the same seeds runs under ``transfer_guard`` and the
    profiler (the path's launches, held to the initial round's +
    ``rounds`` × one profiled replay's) and must repeat the first. Every
    cell's ``inr`` is > 0 and changes between rounds. Then a replay
    against one single-cell seed's (FedAvgM and int8, in turns), the
    capture's ms and the device memory."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_cohort, build_experiment
    from repro_torch.api.scenario import multicell_fleet_spec
    lanes = seeds * cells
    what = f"multicell cohort ({seeds} seeds x {cells} cells)"
    spec = ExperimentSpec(cohort=seeds, aggregator="fedavgm:0.9",
                          compressor="int8", fleet=multicell_fleet_spec(
                              cells, channel=DYNAMIC_RHO))
    fns = kernel_fns()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    runner = build_cohort(spec)
    t0 = time.perf_counter()
    first = runner.run(rounds=rounds)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    prog = runner.program
    check(prog.graph is not None and prog.lanes == lanes and prog.ph.dynamic
          and prog.ph.fading,
          "the multicell cohort's round was not one captured graph for all "
          "lanes with its fade and cross-cell reduction")
    ch, guarded_ms, launches, wrapped = profiled_cohort_run(
        torch, fns, runner, rounds, what)
    check(runner.program is prog, "the second multicell run captured again")
    check(same_history(first, ch)
          and np.array_equal(first.inr, ch.inr),
          "two multicell cohort runs from the same seeds differ")
    check(ch.accuracy.shape == (lanes, rounds + 1)
          and bool(np.isfinite(ch.accuracy).all() and np.isfinite(ch.T_k).all()
                   and np.isfinite(ch.E_k).all()),
          f"multicell history: shape {ch.accuracy.shape} or non-finite")
    check(ch.inr.shape == (lanes, rounds) and bool(np.all(ch.inr > 0)),
          f"multicell inr: shape {ch.inr.shape} or a cell with none: "
          f"{ch.inr.tolist()}")
    check(all(len(set(row.tolist())) > 1 for row in ch.inr),
          f"a cell's inr did not change between rounds: {ch.inr.tolist()}")
    print(f"  {what}: lanes {list(zip(ch.seeds, ch.lane_cells))}; first run "
          f"(initial round + {rounds}, capture included) {first_ms:.1f} ms, "
          f"capture {prog.capture_ms:.1f} ms; a second run under "
          f"transfer_guard (0 host syncs) and the profiler {guarded_ms:.1f} "
          f"ms, equal to the first")
    print(f"  inr by lane and round: {np.round(ch.inr, 3).tolist()}")
    print(f"  T_k by lane: {np.round(ch.T_k, 5).tolist()}")
    print(f"  final accuracy by lane "
          f"{[round(float(a), 4) for a in ch.final_accuracy]}")

    single = build_experiment(ExperimentSpec(aggregator="fedavgm:0.9",
                                             compressor="int8"))
    single.run(rounds=1)
    single_prog = single_program(single)
    check(single_prog.graph is not None, "the single-cell round was not "
                                         "captured")
    exps = runner.experiments
    batch = torch.stack([e.draws.batch_indices(
        prog.pad, spec.local_iters, spec.batch_size, spec.samples_per_client)
        for e in exps])
    fade = torch.stack([e.draws.channel_step((spec.clients,)) for e in exps])
    batch1 = single.draws.batch_indices(single_prog.pad, spec.local_iters,
                                        spec.batch_size,
                                        spec.samples_per_client)
    walls = {"single": [], "cohort": []}
    for _ in range(3):
        for name, fn in (("single", lambda: single_prog.replay(batch1)),
                         ("cohort", lambda: prog.replay(batch, None, fade)),
                         ("cohort", lambda: prog.replay(batch, None, fade)),
                         ("single", lambda: single_prog.replay(batch1))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    ms = {k: float(np.median(v)) for k, v in walls.items()}
    n_dev, busy, inside, by_name, kept, window = profile_replay(
        torch, prog, batch, None, fade)
    reserved = (torch.cuda.memory_reserved() - reserved0) / 2**20
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"  replay wall (host clock, synchronised; median of "
          f"{len(walls['cohort'])}, in turns): {what} {ms['cohort']:.1f} ms, "
          f"one single-cell seed (fedavgm, int8) {ms['single']:.1f} ms "
          f"({ms['cohort'] / ms['single']:.2f}x for {lanes} lanes)")
    print(f"  one profiled replay: {n_dev} device launches, {busy:.2f} ms "
          f"busy in its own device window of {window:.2f} ms: idle share "
          f"{idle_share(busy, window):.4f}; inside it: {inside} (marks kept "
          f"before and after it: {kept[0]} and {kept[1]})")
    for i, (name, (n, t)) in enumerate(sorted(by_name.items(),
                                              key=lambda kv: -kv[1][1])[:5]):
        print(f"  kernel #{i + 1} {name[:72]}: {n} launches, {t:.3f} ms")
    print(f"  device memory: reserved +{reserved:.1f} MiB over the phase, "
          f"peak allocated {peak:.1f} MiB")
    hold_path_launches(launches, wrapped, inside, rounds, what)
    return launches, dict(replay_ms=ms["cohort"],
                          single_replay_ms=ms["single"],
                          capture_ms=prog.capture_ms, device_launches=n_dev,
                          busy_ms=busy, window_ms=window,
                          reserved_mib=reserved, peak_mib=peak)


def static_cells_phase(torch, rounds=2):
    """(c) ``ExperimentSpec(fleet=multicell_fleet_spec(2))`` (build-time
    interference) as a cohort: each cell lane against its
    ``build_experiment(spec, cell=c)`` single traced run
    (``lane_vs_single``), and whether it is equal bit for bit."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_cohort, build_experiment
    from repro_torch.api.scenario import multicell_fleet_spec
    spec = ExperimentSpec(fleet=multicell_fleet_spec(2))
    runner = build_cohort(spec)
    ch = runner.run(rounds=rounds)
    check(runner.program.lanes == 2 and ch.inr is None,
          "(c) the static 2-cell cohort is not 2 independent lanes")
    bits = []
    for c in range(2):
        single = build_experiment(spec, cell=c)
        h = single.run(rounds=rounds)
        check(h.seconds == [] and float(single.fleet.inr.min()) > 0,
              "(c) a cell's single run is not traced or has no interference")
        d = lane_vs_single(ch, c, runner.experiments[c], single, h,
                           f"static cell lane {c}", spec.test_samples)
        bits.append(bool(np.all(np.asarray(d) == 0)))
    print(f"  (c) static 2-cell cohort ({rounds} rounds): each cell lane "
          f"equals its build_experiment(spec, cell=c) run (tol: "
          f"lane_vs_single); bit for bit: {bits}")


def topk_phase(torch, rounds=3):
    """(d) ``ExperimentSpec(compressor="topk:0.01", aggregator=
    "fedavgm:0.9")``: the traced run against the host loop from the same
    seed, bit for bit; SAO's T for round 1's selection with the compressed
    payload z against the full one, in this call."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.core.sao import solve_sao
    from repro_torch.core.wireless import fleet_arrays, sample_fleet
    spec = ExperimentSpec(compressor="topk:0.01", aggregator="fedavgm:0.9")
    traced, host = (build_experiment(spec) for _ in range(2))
    h_t = traced.run(rounds=rounds)
    h_h = host._run_host(None, rounds, 0.0)
    torch.cuda.synchronize()
    check(h_t.seconds == [], "(d) run() did not take the traced path")
    same_sel = all(np.array_equal(a, b)
                   for a, b in zip(h_t.selected, h_h.selected))
    d_row = float((traced.global_vec - host.global_vec).abs().max())
    d_v = float((traced.aggregator.init_flat_state(traced.global_vec)
                 - host.aggregator.init_flat_state(host.global_vec))
                .abs().max())
    equal = (same_sel and h_t.T_k == h_h.T_k and h_t.E_k == h_h.E_k
             and h_t.accuracy == h_h.accuracy and d_row == 0.0 and d_v == 0.0)
    print(f"  (d) topk:0.01 + fedavgm:0.9, {rounds} rounds: traced vs host "
          f"loop selections equal {same_sel}; T_k {h_t.T_k == h_h.T_k}, E_k "
          f"{h_t.E_k == h_h.E_k}, accuracy {h_t.accuracy == h_h.accuracy} "
          f"equal; global row max abs diff {d_row:.3e}, momentum {d_v:.3e}: "
          f"{'bit for bit' if equal else 'NOT EQUAL'}")
    check(equal, "(d) the topk traced run differs from the host loop")
    sel = np.asarray(h_t.selected[1])
    full = sample_fleet(spec.clients, seed=spec.resolved_fleet_seed)
    T_c = float(solve_sao(fleet_arrays(traced.fleet.select(sel), DEVICE),
                          spec.bandwidth_mhz).T)
    T_u = float(solve_sao(fleet_arrays(full.select(sel), DEVICE),
                          spec.bandwidth_mhz).T)
    print(f"  (d) SAO T for round 1's selection: z = "
          f"{traced.fleet.z[0]:.4f} Mbit (topk:0.01) {T_c:.6f} s, z = "
          f"{full.z[0]:.4f} Mbit (uncompressed) {T_u:.6f} s")
    check(T_c < T_u, f"(d) SAO's T with the compressed z ({T_c}) is not "
                     f"below T with the full z ({T_u})")


def rayleigh_phase(torch):
    """(e) ``rayleigh-block`` against ``gauss-markov:0``: tiny traced runs
    on the card from the same draws, equal bit for bit."""
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.api.scenario import FleetSpec
    out = []
    for channel in ("rayleigh-block", "gauss-markov:0"):
        exp = build_experiment(ExperimentSpec(**WIRELESS_TINY,
                                              fleet=FleetSpec(channel=channel)))
        h = exp.run()
        check(h.seconds == [], f"(e) {channel}: not the traced path")
        out.append((h, exp.global_vec.cpu()))
    (a, ga), (b, gb) = out
    equal = (all(list(x) == list(y) for x, y in zip(a.selected, b.selected))
             and a.T_k == b.T_k and a.E_k == b.E_k
             and a.accuracy == b.accuracy and torch.equal(ga, gb))
    print(f"  (e) rayleigh-block vs gauss-markov:0 on the card, same draws, "
          f"{len(a.T_k) - 1} rounds: {'equal bit for bit' if equal else 'DIFFER'}"
          f" (T_k {a.T_k})")
    check(equal, "(e) rayleigh-block and gauss-markov:0 differ")


# ---------------------------------------------------------------------------
# phase 11: the paged client store
# ---------------------------------------------------------------------------


PAGED_ROUNDS = 3
KMEANS_ITERS = 50                 # kmeans_fit's and the minibatch fit's
SCALE_MAX_RATIO = 1.5             # rest of a round, 1e6 clients over 1e5
                                  # (benchmarks/bench_round_breakdown.py)
SCALE_SIZES = (100_000, 1_000_000)
SCALE_ROUNDS = 5
DIV_SLACK = dict(rtol=1e-5, atol=1e-4)   # fp32 slack of the drift bound


def kmeans_launches(c, chunks=1):
    """``pairwise_l2`` calls of one K-means fit into ``c`` clusters over a
    stream of ``chunks`` chunks: k-means++ (c − 1 on the first chunk),
    every Lloyd pass over every chunk, the last assignment."""
    return (c - 1) + KMEANS_ITERS * chunks + chunks


def counts_now(fns):
    return {name: fn.launches for name, fn in fns.items()}


def zero_counts(fns):
    for fn in fns.values():
        fn.launches = 0


def hold_counts(counts, expect, what):
    """Fail unless every kernel's launches are ``expect``'s (0 where it
    names none)."""
    want = {name: expect.get(name, 0) for name in KERNELS}
    print(f"  {what}: launches {counts}, derived {want}: "
          f"{'agree' if counts == want else 'DIFFER'}")
    check(counts == want, f"{what}: launches {counts}, not {want}")


def paged_vs_dense_phase(torch, rounds=PAGED_ROUNDS):
    """(a) ``ExperimentSpec(clients=1000)`` — the paper CNN at full width —
    on the paged store (``k_max=1000``: the initial round is one active
    plane; ``chunk_size=128``: 8 chunks; ``div_refresh_every=1``) through
    ``run()``, against the dense host loop from the same seed: the initial
    round and ``rounds`` rounds of ``divergence`` each. Selections, T_k,
    E_k, accuracy, the global row, ``divergences()`` and ``client_tree()``
    must agree bit for bit (each divergence's bits independent of the rows
    in its call), and each path's launches equal the counts derived from
    its code. Returns the paged run's launches."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment

    fns = kernel_fns()
    dense_spec = ExperimentSpec(clients=1000)
    paged_spec = dense_spec.replace(store="paged", k_max=1000,
                                    chunk_size=128, div_refresh_every=1)
    n, c = dense_spec.clients, dense_spec.num_clusters
    refresh = -(-n // paged_spec.chunk_size)
    expect = {
        "dense": {"flat_aggregate": 1 + rounds,
                  "pairwise_l2": kmeans_launches(c) + rounds},
        "paged": {"flat_aggregate": 1 + rounds,
                  # a round: the base row, the refresh, the round's rows
                  "pairwise_l2": kmeans_launches(c)
                  + rounds * (1 + refresh + 1)}}
    runs = {}
    for name, spec in (("dense", dense_spec), ("paged", paged_spec)):
        exp = build_experiment(spec, device=DEVICE)
        torch.cuda.synchronize()
        zero_counts(fns)
        t0 = time.perf_counter()
        hist = (exp.run(rounds=rounds) if name == "paged"
                else exp._run_host(None, rounds, 0.0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_now(fns)
        print(f"  {name}: the initial round + {rounds} rounds in "
              f"{wall:.2f} s; round walls (s) "
              + ", ".join(f"{s:.3f}" for s in hist.seconds))
        hold_counts(counts, expect[name], f"(a) {name}")
        runs[name] = (exp, hist, counts)
    (dense, h_d, _), (paged, h_p, counts) = runs["dense"], runs["paged"]
    for k, (a, b) in enumerate(zip(h_d.selected, h_p.selected)):
        check(np.array_equal(a, b), f"(a) round {k}: paged selected "
                                    f"{list(b)}, dense {list(a)}")
    check(h_p.T_k == h_d.T_k and h_p.E_k == h_d.E_k,
          f"(a) T_k/E_k differ: paged {h_p.T_k} {h_p.E_k}, dense {h_d.T_k} "
          f"{h_d.E_k}")
    check(h_p.accuracy == h_d.accuracy, "(a) accuracies differ")
    check(bool(torch.equal(paged.global_vec, dense.global_vec)),
          "(a) the global rows differ")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_p = paged.divergences()          # a refresh: 1000 rows in 8 chunks
    refresh_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    d_d = dense.divergences()          # one call over the plane
    dense_div_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(d_p, d_d), "(a) divergences differ: max abs "
          f"{float(np.max(np.abs(d_p - d_d)))}")
    t_p, t_d = paged.client_tree(), dense.client_tree()
    check(all(np.array_equal(t_p[k], t_d[k]) for k in t_d),
          "(a) the client trees differ")
    print(f"  (a) paged = dense bit for bit: selections, T_k, E_k, "
          f"accuracy, global row, divergences, client tree; divergences() "
          f"{refresh_ms:.1f} ms paged (base row + {refresh} chunks of "
          f"{paged_spec.chunk_size} rows assembled on the host and copied "
          f"in), {dense_div_ms:.1f} ms dense (one call)")
    return counts, dict(refresh_ms=refresh_ms, dense_div_ms=dense_div_ms,
                        paged_s=h_p.seconds, dense_s=h_d.seconds)


class LargestAllocation:
    """The largest single device allocation made inside the block, from the
    caching allocator's event record (``torch.cuda.memory``'s history, no
    stack traces kept)."""

    def __init__(self, torch):
        self.torch = torch
        self.largest = 0

    def __enter__(self):
        self.torch.cuda.memory._record_memory_history(
            enabled="all", context=None, stacks="python",
            max_entries=2_000_000)
        return self

    def __exit__(self, *exc):
        mem = self.torch.cuda.memory
        try:
            snap = mem._snapshot()
        finally:
            mem._record_memory_history(enabled=None)
        events = [e for trace in snap["device_traces"] for e in trace
                  if e["action"] == "alloc"]
        check(events, "the allocator recorded no allocation")
        self.largest = max(e["size"] for e in events)
        self.events = len(events)
        return False


def paged_waves_phase(torch, rounds=PAGED_ROUNDS):
    """(b) ``ExperimentSpec(clients=4000, store="paged", k_max=500,
    cluster="minibatch", div_refresh_every=0)``: the initial round in 8
    waves of 500 with the streaming eq.-(4) mean, the minibatch K-means
    over 28 chunks of 147 rows, then ``rounds`` rounds on the drift-bounded
    signal. The streaming mean against one ``flat_aggregate`` of the 4000
    rows assembled on the card (rtol 1e-5); every client's true
    ‖w_n − g‖ within ``divergence ± drift``; the labels cover every row;
    no allocation as large as the ``[N, P]`` plane; the launches derived
    from the code."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.kernels import ops

    fns = kernel_fns()
    spec = ExperimentSpec(clients=4000, store="paged", k_max=500,
                          cluster="minibatch", div_refresh_every=0)
    t0 = time.perf_counter()
    exp = build_experiment(spec, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n, p, c = spec.clients, exp.flat_spec.total, spec.num_clusters
    waves, chunks = -(-n // exp.k_max), -(-n // exp.chunk_size)
    plane_bytes = n * p * 4
    data_bytes = torch.cuda.memory_allocated()
    zero_counts(fns)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with LargestAllocation(torch) as init_mem:
        exp.initial_round()
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    init_counts = counts_now(fns)
    hold_counts(init_counts, {"flat_aggregate": 1,
                              "pairwise_l2": kmeans_launches(c, chunks)},
                f"(b) the initial round ({waves} waves, the unit-row fold; "
                f"minibatch K-means over {chunks} chunks)")
    labels = exp.cluster_labels
    check(len(labels) == n and 0 <= labels.min() and labels.max() < c,
          f"(b) {len(labels)} labels in [{labels.min()}, {labels.max()}] for "
          f"{n} clients and {c} clusters")
    check(exp.store.num_touched == n, "(b) not every client was trained")

    rows = torch.cat([torch.as_tensor(b).to(DEVICE)
                      for b in exp.store.iter_chunks()])
    sizes = torch.as_tensor(exp.fed.sizes, dtype=torch.float32,
                            device=DEVICE)
    want = ops.flat_aggregate(rows, sizes)
    err = float((exp.global_vec - want).abs().max())
    rel = float(((exp.global_vec - want).abs()
                 / want.abs().clamp(min=1e-3)).max())
    ok = bool(torch.allclose(exp.global_vec, want, rtol=1e-5, atol=1e-6))
    print(f"  (b) the streaming mean of {waves} waves against one "
          f"flat_aggregate of the {n} rows assembled on the card "
          f"({rows.numel() * 4 / 2**30:.2f} GiB): max abs err {err:.3e}, "
          f"max rel err {rel:.3e} where |mean| >= 1e-3 (tol rtol 1e-5, "
          f"atol 1e-6: {'ok' if ok else 'FAIL'})")
    check(ok, f"(b) the streaming mean differs from one fold by {err}")
    del rows, want
    torch.cuda.empty_cache()

    zero_counts(fns)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with LargestAllocation(torch) as round_mem:
        hist = exp.run(rounds=rounds, include_initial_round=False)
        torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0
    round_peak = torch.cuda.max_memory_allocated()
    # round 1 refreshes every row (the initial round's write is forced);
    # then the drift bounds the stale rows: the base row and the round's
    hold_counts(counts_now(fns), {
        "flat_aggregate": rounds,
        "pairwise_l2": (1 + chunks + 1) + (rounds - 1) * 2},
        f"(b) {rounds} rounds (div_refresh_every=0)")
    check(len(hist.accuracy) == rounds, "(b) expected no initial round")

    rows = torch.cat([torch.as_tensor(b).to(DEVICE)
                      for b in exp.store.iter_chunks()])
    true = ops.client_divergence(rows, exp.global_vec).cpu().numpy()
    del rows
    torch.cuda.empty_cache()
    st = exp.stats
    slack = DIV_SLACK["atol"] + DIV_SLACK["rtol"] * true
    over = np.abs(true - st.divergence) - st.drift - slack
    print(f"  (b) true divergence within divergence ± drift for every one "
          f"of {n} clients: worst margin {float(over.max()):.3e} (<= 0), "
          f"max drift {float(st.drift.max()):.4f}, stale rows "
          f"{int((st.drift > 0).sum())}")
    check(float(over.max()) <= 0.0, "(b) a divergence outside its drift "
                                    "bound")
    peak = max(init_peak, round_peak)
    largest = max(init_mem.largest, round_mem.largest)
    print(f"  (b) device memory: data {data_bytes / 2**20:.1f} MiB (the "
          f"experiment's tensors and what earlier phases hold); peak "
          f"{init_peak / 2**20:.1f} MiB over the initial round, "
          f"{round_peak / 2**20:.1f} MiB over the rounds; data + N·P·4 = "
          f"{(data_bytes + plane_bytes) / 2**20:.1f} MiB (peak "
          f"{'below' if peak < data_bytes + plane_bytes else 'ABOVE'} it: "
          f"the {exp.k_max}-client wave's training workspace counts too); "
          f"the largest single allocation {largest / 2**20:.1f} MiB of "
          f"{init_mem.events + round_mem.events} against the [N, P] "
          f"plane's {plane_bytes / 2**20:.1f} MiB")
    check(largest < plane_bytes, "(b) an allocation as large as the "
                                 "[N, P] plane")
    print(f"  (b) build {build_s:.1f} s, initial round {init_s:.1f} s, "
          f"{rounds} rounds {rounds_s:.2f} s (walls "
          + ", ".join(f"{s:.3f}" for s in hist.seconds) + ")")
    return dict(peak=peak, data=data_bytes, largest=largest,
                init_s=init_s)


def warm_sao_graphs(torch, sizes):
    """Capture SAO's graph for each set size in ``sizes`` (a shape's
    second solve captures it, ``core/graphs.py``), so that no timed round
    below pays an eager solve or a capture because churn changed its set
    size."""
    from repro_torch.api.registry import ALLOCATORS
    from repro_torch.core.wireless import fleet_arrays, sample_fleet
    sao = ALLOCATORS.resolve("sao")
    for k in sizes:
        arr = fleet_arrays(sample_fleet(k, seed=k), DEVICE)
        arr.pop("xgain", None)
        for _ in range(2):
            sao.allocate(arr, 20.0)
    torch.cuda.synchronize()


def population_phase(torch, sizes=SCALE_SIZES, rounds=SCALE_ROUNDS):
    """(c) ``ExperimentSpec(clients=N, store="paged", selection="random",
    churn_leave=0.01, churn_join=0.1)`` — the paper CNN, S = 10, lazy and
    vectorized partitions — at N = 1e5 and 1e6, as the reference's scale
    sweep runs it: no initial round, one warm-up round, then ``rounds``
    timed rounds each after ``_churn_step_host``; the selection (the one
    deliberate O(N) step) timed apart. The rest of a round at 1e6 within
    1.5x of 1e5's, and the device's peak growing from 1e5 to 1e6 by no
    more than the [N, D] labels, the sizes and the fleet's fp32 arrays."""
    import gc

    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.data.partition import VECTORIZED_PARTITION_MIN

    warm_sao_graphs(torch, range(7, 11))
    out = {}
    for n in sizes:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        spec = ExperimentSpec(clients=n, store="paged", selection="random",
                              churn_leave=0.01, churn_join=0.1)
        t0 = time.perf_counter()
        exp = build_experiment(spec, device=DEVICE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(exp.fed.lazy and n >= VECTORIZED_PARTITION_MIN,
              f"(c) N={n}: expected a lazy, vectorized partition")
        exp.round("random")                      # warm-up
        torch.cuda.synchronize()
        walls, churn_ms, picked = [], [], []
        for _ in range(rounds):
            t0 = time.perf_counter()
            exp._churn_step_host()
            churn_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = exp.round("random")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            picked.append(len(res.selected))
            check(math.isfinite(res.T_k) and 0.0 <= res.accuracy <= 1.0,
                  f"(c) N={n}: a bad round {res}")
        sel = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            exp.select("random")
            sel.append((time.perf_counter() - t0) * 1e3)
        round_ms, sel_ms = float(np.median(walls)), float(np.median(sel))
        peak = torch.cuda.max_memory_allocated() - before
        check(bool(torch.isfinite(exp.global_vec).all()),
              f"(c) N={n}: non-finite global row")
        check(0 < exp.store.num_touched <= (rounds + 1) * 10,
              f"(c) N={n}: {exp.store.num_touched} rows written")
        out[n] = dict(build_s=build_s, round_ms=round_ms, sel_ms=sel_ms,
                      rest_ms=round_ms - sel_ms,
                      churn_ms=float(np.median(churn_ms)),
                      store_mib=exp.store.nbytes / 2**20,
                      stats_mib=exp.stats.nbytes / 2**20,
                      peak_mib=peak / 2**20,
                      per_client_bytes=exp.fed.labels.shape[1] * 4 + 4 + 9 * 4)
        print(f"  (c) N={n}: build {build_s:.1f} s; round median "
              f"{round_ms:.1f} ms (walls "
              + ", ".join(f"{w:.1f}" for w in walls)
              + f"; clients a round {picked}); selection {sel_ms:.2f} ms, "
              f"rest {round_ms - sel_ms:.1f} ms; churn step "
              f"{out[n]['churn_ms']:.2f} ms; host store "
              f"{out[n]['store_mib']:.2f} MiB (+ stats "
              f"{out[n]['stats_mib']:.2f} MiB); device peak "
              f"{out[n]['peak_mib']:.1f} MiB over the build and rounds")
        del exp, res
    lo, hi = (out[n] for n in sizes)
    ratio = hi["rest_ms"] / lo["rest_ms"]
    print(f"  (c) rest of a round {sizes[1]} / {sizes[0]}: {ratio:.3f} (gate "
          f"{SCALE_MAX_RATIO}); selection {hi['sel_ms']:.2f} against "
          f"{lo['sel_ms']:.2f} ms")
    check(ratio <= SCALE_MAX_RATIO, f"(c) the rest of a round grew "
                                    f"{ratio:.2f}x from 1e5 to 1e6 clients")
    growth = hi["peak_mib"] - lo["peak_mib"]
    allow = (sizes[1] - sizes[0]) * lo["per_client_bytes"] / 2**20
    print(f"  (c) device peak grew {growth:.1f} MiB from {sizes[0]} to "
          f"{sizes[1]} clients; the [N, D] int32 labels, the sizes and the "
          f"fleet's 9 fp32 arrays grow {allow:.1f} MiB")
    check(growth <= allow, f"(c) device peak grew {growth:.1f} MiB, more "
                           f"than the per-client data's {allow:.1f} MiB")
    return out


# ---------------------------------------------------------------------------
# phase 12: the buffered-asynchronous engine
# ---------------------------------------------------------------------------


ASYNC = dict(aggregator="fedbuff:4:0.5", churn_leave=0.05, churn_join=0.2)
ASYNC_TICKS = 8
ASYNC_M = 4
ASYNC_SCALE_TICKS = 5
# the per-client device columns of the paged tick at population scale
# [bytes]: the [N, 128] int32 labels, the sizes, the fleet's 9 fp32
# arrays, the stats table (4 + 4 + 4 + 4 + 1 + 4 + 4 + 4), the carry's
# int64 K-means labels, and the tick's [N] temporaries (the permutation
# draw's uniforms and order, the completion times and their padded copy,
# their order and ranks, the masks)
ASYNC_PER_CLIENT = dict(labels=128 * 4, sizes=4, fleet=9 * 4, stats=29,
                        kmeans_labels=8,
                        tick=4 + 8 + 4 + 4 + 8 + 8 + 8 + 4)


def async_agreement(torch):
    """(a) A tiny ``fedbuff:2:0.5`` run under churn 0.3/0.3 on the CPU
    (eager) and on the card (the captured tick), from the same draws: the
    same selections, participation, active counts and staleness; T_k and
    E_k within rtol 2e-3, the global row within atol 1e-4."""
    from repro_torch.api import ExperimentSpec, build_experiment
    spec = ExperimentSpec(dataset="fashion", clients=8, samples_per_client=16,
                          train_samples=160, test_samples=80, local_iters=2,
                          batch_size=8, devices_per_round=4, num_clusters=4,
                          rounds=4, aggregator="fedbuff:2:0.5",
                          churn_leave=0.3, churn_join=0.3)
    out = {}
    for dev in ("cpu", DEVICE):
        exp = build_experiment(spec, device=dev, draws=_CpuDraws(0, dev))
        out[dev] = (exp.run(), exp.global_vec.cpu())
    (h_cpu, g_cpu), (h_gpu, g_gpu) = out["cpu"], out[DEVICE]
    check(h_gpu.seconds == [], "(a) the card's run was not the captured tick")
    for k, (a, b) in enumerate(zip(h_cpu.selected, h_gpu.selected)):
        check(list(a) == list(b), f"(a) tick {k}: dispatched {list(b)} on "
                                  f"the card, {list(a)} on the CPU")
    for name in ("participation", "active", "staleness"):
        a, b = getattr(h_cpu, name), getattr(h_gpu, name)
        check(a == b, f"(a) {name} {b} on the card, {a} on the CPU")
    for name in ("T_k", "E_k"):
        a, b = getattr(h_cpu, name), getattr(h_gpu, name)
        check(all(math.isclose(x, y, rel_tol=2e-3) for x, y in zip(a, b)),
              f"(a) {name} {b} on the card, {a} on the CPU")
    err = float((g_cpu - g_gpu).abs().max())
    print(f"  (a) tiny fedbuff:2:0.5 under churn 0.3/0.3, CPU vs card: "
          f"dispatches, participation {h_gpu.participation}, active "
          f"{h_gpu.active} and staleness {h_gpu.staleness} equal; T_k/E_k "
          f"within rtol 2e-3; global row max_abs_err={err:.3e} (tol 1e-4)")
    check(err <= 1e-4, f"(a) the global row differs by {err}")


def async_degenerate_phase(torch, ticks=5):
    """(b) ``fedbuff:10:0`` on ``ExperimentSpec()`` (M = S_pad = 10, no
    churn: the tick's static branch is the synchronous round body) against
    the synchronous traced run from the same seed: every history value
    and the global row bit for bit. Returns the synchronous experiment."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment
    sync = build_experiment(ExperimentSpec(), device=DEVICE)
    h_s = sync.run(rounds=ticks)
    deg = build_experiment(ExperimentSpec(aggregator="fedbuff:10:0"),
                           device=DEVICE)
    h_d = deg.run(rounds=ticks)
    torch.cuda.synchronize()
    check(h_s.seconds == [] and h_d.seconds == [],
          "(b) a run did not take the device-resident path")
    check(single_program(deg).ph.degenerate,
          "(b) fedbuff:10:0 did not take the synchronous branch")
    for k, (a, b) in enumerate(zip(h_s.selected, h_d.selected)):
        check(np.array_equal(a, b), f"(b) round {k}: {list(b)} against "
                                    f"the synchronous {list(a)}")
    for name in ("accuracy", "T_k", "E_k", "band_mhz"):
        check(getattr(h_s, name) == getattr(h_d, name),
              f"(b) {name} differs from the synchronous run's")
    check(bool(torch.equal(sync.global_vec, deg.global_vec)),
          "(b) the global rows differ")
    check(h_d.staleness == [0.0] * ticks and h_d.participation == [10.0] * ticks
          and h_d.active == [40.0] * ticks,
          f"(b) traces {h_d.participation} {h_d.staleness} {h_d.active}")
    print(f"  (b) fedbuff:10:0 = ExperimentSpec() traced over the initial "
          f"round + {ticks} ticks bit for bit: selections, accuracy, T_k, "
          f"E_k, band, global row; participation 10, staleness 0, active 40")
    return sync


def async_tick_phase(torch, sync, ticks=ASYNC_TICKS):
    """(c) ``ExperimentSpec(aggregator="fedbuff:4:0.5", churn_leave=0.05,
    churn_join=0.2)`` — the paper CNN at full width — through ``run()``:
    the initial round and ``ticks`` ticks, one capture and one replay a
    tick. A second run from the same seed with sync debug mode "warn" (host
    syncs counted from the initial round to the last replay) must repeat
    it; a third, one tick a ``run()`` call, must repeat it too while
    showing each tick's availability (no unavailable client dispatched, no
    unavailable client in flight). Then ms a tick against ``sync``'s
    replay, one replay profiled, and the kernels' launches of a whole run
    under the profiler held to the counts derived from the tick's code:
    ``flat_aggregate`` the initial round's fold + one candidate fold a
    tick, ``pairwise_l2`` the K-means + two a tick (the selection's
    divergence over the plane, the candidates')."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment

    spec = ExperimentSpec(**ASYNC)
    fns = kernel_fns()
    exp = build_experiment(spec, device=DEVICE)
    prog = single_program(exp)
    calls = {"capture": 0, "replay": 0}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(prog, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(prog, name, counted)
    t0 = time.perf_counter()
    hist = exp.run(rounds=ticks)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    check(hist.seconds == [] and calls == {"capture": 1, "replay": ticks},
          f"(c) {calls} for {ticks} ticks, not one capture and a replay a "
          "tick")
    check(single_program(exp) is prog, "(c) run() used another program")
    for k in range(len(hist.accuracy)):
        extra = ("" if k == 0 else
                 f" participation={hist.participation[k - 1]:.0f} "
                 f"staleness={hist.staleness[k - 1]:.3f} "
                 f"active={hist.active[k - 1]:.0f}")
        print(f"  (c) tick {k}: accuracy={hist.accuracy[k]:.4f} "
              f"T={hist.T_k[k]:.6f} s E={hist.E_k[k]:.6f} J "
              f"dispatched={list(map(int, hist.selected[k]))}{extra}")
    check(all(math.isfinite(v) for v in hist.accuracy + hist.T_k + hist.E_k),
          "(c) a non-finite history value")
    check(max(hist.staleness) > 0, "(c) no tick folded a stale update")
    check(all(p <= ASYNC_M for p in hist.participation),
          f"(c) a fire folded more than {ASYNC_M}: {hist.participation}")
    check(bool(torch.isfinite(exp.global_vec).all()), "(c) non-finite row")

    # a second run from the same seed, host syncs counted
    again = build_experiment(spec, device=DEVICE)
    state, inputs = again.traced_state(), again.traced_inputs()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = prog(state, *inputs, draws=again.draws, rounds=ticks,
                       with_init=True)
            enqueue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    second_ms = (time.perf_counter() - t0) * 1e3
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()]
    check(res.rounds.accuracy.cpu().tolist() == hist.accuracy[1:]
          and res.rounds.T.cpu().tolist() == hist.T_k[1:],
          "(c) a second run from the same seed differs")
    print(f"  (c) first run (initial round + {ticks} ticks, capture "
          f"included) {first_ms:.1f} ms; capture {prog.capture_ms:.1f} ms; a "
          f"second run {second_ms:.1f} ms, {enqueue_ms:.1f} ms of it "
          f"enqueueing; host syncs in it: {len(syncs)}"
          f"{' ' + syncs[0][:120] if syncs else ''}")
    check(not syncs, "(c) the asynchronous run waited for the card")

    # tick by tick from the same seed: the mask each tick selected under
    steps = build_experiment(spec, device=DEVICE)
    for k in range(ticks):
        h = steps.run(rounds=1, include_initial_round=(k == 0))
        st = steps.stats
        sel = h.selected[-1]
        check(bool(np.all(st.avail[sel])),
              f"(c) tick {k + 1}: dispatched {list(sel)}, not all "
              f"available {list(np.flatnonzero(st.avail))}")
        check(bool(np.all(np.isinf(st.t_done[~st.avail]))),
              f"(c) tick {k + 1}: an unavailable client in flight")
        check(np.array_equal(sel, hist.selected[k + 1])
              and h.accuracy[-1] == hist.accuracy[k + 1]
              and h.participation == [hist.participation[k]],
              f"(c) tick {k + 1} run alone differs from the {ticks}-tick run")
    check(bool(torch.equal(steps.global_vec, exp.global_vec)),
          "(c) the tick-by-tick run's global row differs")
    print(f"  (c) one tick a run() call from the same seed: every dispatch "
          f"among the available clients, no unavailable client in flight, "
          f"the history and the global row of the {ticks}-tick run bit for "
          f"bit (the clock {float(steps.stats.t_now):.4f} s continued)")

    # ms a tick against the synchronous replay, in turns
    sprog = single_program(sync)
    batch = exp.draws.batch_indices(prog.pad, spec.local_iters,
                                    spec.batch_size, spec.samples_per_client)
    churn = torch.ones((2, spec.clients), device=DEVICE)   # nobody moves
    prog.load(exp.traced_state(), exp.traced_inputs())
    sprog.load(sync.traced_state(), sync.traced_inputs())
    walls = {"async": [], "sync": []}
    for _ in range(3):
        for name, fn in (("sync", lambda: sprog.replay(batch)),
                         ("async", lambda: prog.replay(batch, churn=churn)),
                         ("async", lambda: prog.replay(batch, churn=churn)),
                         ("sync", lambda: sprog.replay(batch))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    ms = {k: float(np.median(v)) for k, v in walls.items()}
    n_dev, busy, inside, by_name, kept, window = profile_replay(
        torch, prog, batch, churn=churn)
    print(f"  (c) tick wall (host clock, synchronised; median of 6, in "
          f"turns): asynchronous {ms['async']:.1f} ms, the synchronous "
          f"replay {ms['sync']:.1f} ms ({ms['async'] / ms['sync']:.3f}x)")
    print(f"  (c) one profiled tick: {n_dev} device launches, {busy:.2f} ms "
          f"busy in its own device window of {window:.2f} ms: idle share "
          f"{idle_share(busy, window):.4f}; inside it: {inside} (marks kept "
          f"before and after it: {kept[0]} and {kept[1]})")
    for i, (name, (n, t)) in enumerate(sorted(by_name.items(),
                                              key=lambda kv: -kv[1][1])[:5]):
        print(f"  kernel #{i + 1} {name[:72]}: {n} launches, {t:.3f} ms")
    tick_expect = {"flat_aggregate": 1, "pairwise_l2": 2}
    check(inside == tick_expect, f"(c) a tick launched {inside}, derived "
                                 f"{tick_expect}")

    third = build_experiment(spec, device=DEVICE)
    state, inputs = third.traced_state(), third.traced_inputs()
    launches, wrapped = path_launches(torch, fns, lambda: prog(
        state, *inputs, draws=third.draws, rounds=ticks, with_init=True),
        ticks, "(c) the asynchronous path")
    c = spec.num_clusters
    hold_counts(launches, {
        "flat_aggregate": 1 + ticks * tick_expect["flat_aggregate"],
        "pairwise_l2": kmeans_launches(c) + ticks * tick_expect["pairwise_l2"]},
        "(c) a whole run (initial round + ticks) under the profiler")
    hold_path_launches(launches, wrapped, inside, ticks,
                       "(c) the asynchronous path")
    return exp, hist, launches, dict(
        tick_ms=ms["async"], sync_ms=ms["sync"], capture_ms=prog.capture_ms,
        device_launches=n_dev, busy_ms=busy, window_ms=window)


def async_cohort_phase(torch, single, h_single, ticks=ASYNC_TICKS):
    """(d) The spec of (c) with ``cohort=2``: the initial round and
    ``ticks`` replays of ONE captured tick for both lanes under
    ``transfer_guard`` and the profiler (the path's launches); lane 0
    against (c)'s run of seed 0 (``single``, ``h_single``) and lane 1
    against a single run of seed 1, bit for bit: dispatches, accuracy,
    T_k, E_k, the traces and the global row."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_cohort, build_experiment

    spec = ExperimentSpec(**ASYNC, cohort=2)
    fns = kernel_fns()
    runner = build_cohort(spec)
    t0 = time.perf_counter()
    first = runner.run(rounds=ticks)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    prog = runner.program
    check(prog.graph is not None and prog.lanes == 2,
          "(d) the cohort's tick was not captured as one graph for 2 lanes")
    ch, guarded_ms, launches, wrapped = profiled_cohort_run(
        torch, fns, runner, ticks, "(d) the asynchronous cohort")
    check(runner.program is prog, "(d) the second cohort run captured again")
    check(same_history(first, ch)
          and np.array_equal(first.staleness, ch.staleness),
          "(d) two cohort runs from the same seeds differ")
    check(ch.participation.shape == (2, ticks)
          and ch.staleness.shape == (2, ticks),
          f"(d) traces of shape {ch.participation.shape}")
    singles = [(single, h_single)]
    one = build_experiment(spec.replace(seed=spec.seed + 1, cohort=1),
                           device=DEVICE)
    singles.append((one, one.run(rounds=ticks)))
    for i, (e, h) in enumerate(singles):
        hi = ch.history(i)
        lane = runner.experiments[i]
        check(all(np.array_equal(a, b) for a, b in zip(hi.selected,
                                                      h.selected)),
              f"(d) lane {i}: dispatches differ from its single run")
        for name in ("accuracy", "T_k", "E_k", "participation", "staleness",
                     "active"):
            check(getattr(hi, name) == getattr(h, name),
                  f"(d) lane {i}: {name} {getattr(hi, name)} against its "
                  f"single run's {getattr(h, name)}")
        check(bool(torch.equal(lane.global_vec, e.global_vec)),
              f"(d) lane {i}: the global row differs from its single run's")
    print(f"  (d) cohort of 2 (seeds {ch.seeds}): first run {first_ms:.1f} "
          f"ms, capture {prog.capture_ms:.1f} ms; a second under "
          f"transfer_guard and the profiler {guarded_ms:.1f} ms, equal; "
          f"each lane its seed's single run bit for bit; staleness "
          f"{ch.staleness.tolist()}")
    inside = {"flat_aggregate": 1, "pairwise_l2": 2}     # one a tick, lanes
    hold_path_launches(launches, wrapped, inside, ticks,
                       "(d) the asynchronous cohort")
    return launches


def preset_clusters(exp):
    """One cluster label for every client (the ``icas`` runs need none):
    a dense run without its initial round then consumes no K-means draws,
    as a paged one does not."""
    import numpy as np
    from repro_torch.core.clustering import clusters_from_labels
    exp.cluster_labels = np.zeros(exp.fed.num_clients, np.int64)
    exp.clusters = clusters_from_labels(exp.cluster_labels,
                                        exp.fl.num_clusters)
    return exp


def async_paged_phase(torch, ticks=3):
    """(e) ``clients=200, aggregator="fedbuff:4:0.5", selection="icas"``
    under churn 0.05/0.2: the dense tick (captured) against the paged
    store's four pieces (``k_max=200, div_refresh_every=1``) from the same
    seed, ``ticks`` ticks without the initial round: the history, the
    global row and the stats table's ``age``, ``t_done``, ``avail`` and
    ``t_now`` bit for bit. The paged run's launches equal the counts
    derived from its code: a fold a tick; a tick's divergences the base
    row, the touched rows in chunks, the candidates."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment

    fns = kernel_fns()
    spec = ExperimentSpec(clients=200, selection="icas", **ASYNC)
    runs = {}
    for name, s in (("dense", spec),
                    ("paged", spec.replace(store="paged", k_max=200,
                                           div_refresh_every=1))):
        exp = preset_clusters(build_experiment(s, device=DEVICE))
        torch.cuda.synchronize()
        zero_counts(fns)
        t0 = time.perf_counter()
        h = exp.run(rounds=ticks, include_initial_round=False)
        torch.cuda.synchronize()
        runs[name] = (exp, h, counts_now(fns),
                      (time.perf_counter() - t0) * 1e3)
    (d, h_d, _, d_ms), (p, h_p, counts, p_ms) = runs["dense"], runs["paged"]
    chunk = p.chunk_size
    touched, refresh = set(), 0
    for sel in h_p.selected:
        refresh += -(-len(touched) // chunk)
        touched |= set(map(int, sel))
    hold_counts(counts, {"flat_aggregate": ticks,
                         "pairwise_l2": 2 * ticks + refresh},
                f"(e) the paged run ({ticks} ticks, {refresh} refresh "
                f"chunks of up to {chunk} rows)")
    for k, (a, b) in enumerate(zip(h_d.selected, h_p.selected)):
        check(np.array_equal(a, b), f"(e) tick {k}: paged {list(b)}, dense "
                                    f"{list(a)}")
    for name in ("accuracy", "T_k", "E_k", "band_mhz", "participation",
                 "staleness", "active"):
        check(getattr(h_d, name) == getattr(h_p, name),
              f"(e) {name}: dense {getattr(h_d, name)}, paged "
              f"{getattr(h_p, name)}")
    check(bool(torch.equal(d.global_vec, p.global_vec)),
          "(e) the global rows differ")
    for col in ("age", "t_done", "avail", "t_now"):
        check(np.array_equal(getattr(d.stats, col), getattr(p.stats, col)),
              f"(e) the stats column {col} differs")
    print(f"  (e) 200 clients, icas, churn 0.05/0.2: dense tick ≡ paged "
          f"pieces over {ticks} ticks bit for bit (history, traces "
          f"{h_p.participation} / {h_p.staleness} / {h_p.active}, global "
          f"row, age/t_done/avail/t_now); dense {d_ms:.1f} ms (capture "
          f"included), paged {p_ms:.1f} ms (ticks "
          + ", ".join(f"{s * 1e3:.1f}" for s in h_p.seconds) + " ms)")
    return counts


def warm_async_sao(torch, pad):
    """Capture SAO's graph for the asynchronous tick's masked ``pad``-lane
    solve (its key's second solve), so that no timed tick pays it."""
    from repro_torch.api.registry import ALLOCATORS
    from repro_torch.core.wireless import fleet_arrays, sample_fleet
    sao = ALLOCATORS.resolve("sao")
    arr = fleet_arrays(sample_fleet(pad, seed=pad), DEVICE)
    arr.pop("xgain", None)
    mask = torch.ones(pad, dtype=torch.bool, device=DEVICE)
    for _ in range(2):
        sao.allocate_traced(arr, 20.0, mask)
    torch.cuda.synchronize()


def async_population_phase(torch, sizes=SCALE_SIZES,
                           ticks=ASYNC_SCALE_TICKS):
    """(f) ``ExperimentSpec(clients=N, store="paged", selection="random",
    devices_per_round=16, aggregator="fedbuff:4")`` — the paper CNN, lazy
    partitions, no initial round — at N = 1e5 and 1e6, as the reference's
    ``bench_async.py`` scale sweep: one warm-up tick, then ``ticks``
    timed ticks; the O(N) scheduler pieces (``sched`` + ``plan``) timed
    apart on the same carry. The rest of a tick at 1e6 within 1.5x of
    1e5's, and the device's peak growing by no more than the per-client
    columns (``ASYNC_PER_CLIENT``)."""
    import gc

    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.core.async_engine import build_paged_async
    from repro_torch.core.wireless import fleet_arrays

    warm_async_sao(torch, 16)
    out = {}
    for n in sizes:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        spec = ExperimentSpec(clients=n, store="paged", selection="random",
                              devices_per_round=16, aggregator="fedbuff:4")
        t0 = time.perf_counter()
        exp = build_experiment(spec, device=DEVICE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(exp.fed.lazy, f"(f) N={n}: expected a lazy partition")
        exp.run(rounds=1, include_initial_round=False)     # warm-up
        torch.cuda.synchronize()
        h = exp.run(rounds=ticks, include_initial_round=False)
        torch.cuda.synchronize()
        check(len(h.accuracy) == ticks and all(
            math.isfinite(t) for t in h.T_k), f"(f) N={n}: a bad tick")
        check(all(p <= 4 for p in h.participation),
              f"(f) N={n}: participation {h.participation}")
        prog = build_paged_async(
            exp.engine_cfg, exp.aggregator, exp.selector, exp.allocator,
            exp.traced_context(), exp.fl.feature_layer,
            compressor=exp.compressor, channel=exp.channel, churn=exp.churn)
        arr = fleet_arrays(exp.fleet, DEVICE)
        arr.pop("xgain", None)
        state = exp.traced_state()
        sched_ms, plan_ms = [], []
        for _ in range(ticks):
            draw = exp.draws.selector_draw("permutation", n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, arr_f, idx, mask = prog.sched(state, arr, draw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prog.plan(st, arr_f, idx, mask, exp._sizes)
            torch.cuda.synchronize()
            sched_ms.append((t1 - t0) * 1e3)
            plan_ms.append((time.perf_counter() - t1) * 1e3)
        del state, st, arr, arr_f
        tick_ms = float(np.median(h.seconds)) * 1e3
        s_ms = float(np.median(np.add(sched_ms, plan_ms)))
        peak = torch.cuda.max_memory_allocated() - before
        out[n] = dict(build_s=build_s, tick_ms=tick_ms, sched_ms=s_ms,
                      rest_ms=tick_ms - s_ms, peak_mib=peak / 2**20,
                      staged=len(exp.store._staged),
                      in_flight=int(np.isfinite(exp.stats.t_done).sum()),
                      t_now=float(exp.stats.t_now))
        print(f"  (f) N={n}: build {build_s:.1f} s; tick median "
              f"{tick_ms:.1f} ms (walls "
              + ", ".join(f"{w * 1e3:.1f}" for w in h.seconds)
              + f"); sched + plan {s_ms:.2f} ms (sched "
              f"{float(np.median(sched_ms)):.2f}, plan, with SAO's solve, "
              f"{float(np.median(plan_ms)):.2f}), rest {tick_ms - s_ms:.1f} "
              f"ms; participation {h.participation}, staleness "
              f"{[round(x, 3) for x in h.staleness]}; in flight "
              f"{out[n]['in_flight']}, staged rows {out[n]['staged']}; "
              f"device peak {out[n]['peak_mib']:.1f} MiB over the build and "
              f"ticks")
        del exp, h, prog
    lo, hi = (out[n] for n in sizes)
    ratio = hi["rest_ms"] / lo["rest_ms"]
    print(f"  (f) rest of a tick {sizes[1]} / {sizes[0]}: {ratio:.3f} (gate "
          f"{SCALE_MAX_RATIO}); sched + plan {hi['sched_ms']:.2f} against "
          f"{lo['sched_ms']:.2f} ms")
    check(ratio <= SCALE_MAX_RATIO, f"(f) the rest of a tick grew "
                                    f"{ratio:.2f}x from 1e5 to 1e6 clients")
    growth = hi["peak_mib"] - lo["peak_mib"]
    per_client = sum(ASYNC_PER_CLIENT.values())
    allow = (sizes[1] - sizes[0]) * per_client / 2**20
    print(f"  (f) device peak grew {growth:.1f} MiB from {sizes[0]} to "
          f"{sizes[1]} clients; the per-client columns ({per_client} B: "
          f"{ASYNC_PER_CLIENT}) grow {allow:.1f} MiB")
    check(growth <= allow, f"(f) device peak grew {growth:.1f} MiB, more "
                           f"than the per-client columns' {allow:.1f} MiB")
    return out


# ---------------------------------------------------------------------------
# 13. faults, quarantine and checkpoint/resume
# ---------------------------------------------------------------------------

FAULTS_TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
                   train_samples=160, test_samples=80, local_iters=2,
                   batch_size=8, devices_per_round=4, num_clusters=4)
FAULTS_FULL = dict(faults="outage:0.1,corrupt:0.05,byzantine:0.1",
                   quarantine_after=2)
FAULTS_ASYNC = dict(clients=200, selection="icas", aggregator="fedbuff:2:0.5",
                    faults="outage:0.2,corrupt:0.3", quarantine_after=2,
                    churn_leave=0.05, churn_join=0.1)
FAULTS_ROUNDS = 5
FREE_REPLAY_LAUNCHES = 54_991     # ExperimentSpec()'s replay (PERF.md, 19b)
# the selectors' top-k (strategies/traced.py::_stable_top) sorts an int32
# key that ranks NaN last, as lax.top_k does: a shift, an and, a xor, an
# isnan, the fill of the where's scalar, the where and the gather of the
# values, once for the round's one selection, where the float sort's
# values were a slice
TOPK_KEY_LAUNCHES = 7
SCHED_COLUMNS = ("age", "t_done", "avail", "t_now", "cell", "faults",
                 "strikes")


def faults_agreement(torch, rounds=3):
    """(a) A tiny faulty host loop on the CPU and on the card from the same
    draws (the CPU's, the byzantine subset included): selections and the
    fault and strike counts equal, the row within atol 1e-4, T/E within
    rtol 2e-3; once under ``trimmed:0.2``, once under ``clipnorm:1.0``
    (its fold through the kernel). Returns the card's clipnorm run's
    kernel launches."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment
    fns = kernel_fns()
    launches = None
    for agg in ("trimmed:0.2", "clipnorm:1.0"):
        spec = ExperimentSpec(**FAULTS_TINY, aggregator=agg,
                              faults="outage:0.2,corrupt:0.2,byzantine:0.1",
                              quarantine_after=1)
        out = {}
        for dev in ("cpu", DEVICE):
            exp = build_experiment(spec, device=dev, draws=_CpuDraws(0, dev))
            zero_counts(fns)
            h = exp.run(rounds=rounds, target_accuracy=2.0)   # host loop
            out[dev] = (h, exp.global_vec.cpu(), exp.stats)
            if dev == DEVICE:
                counts = counts_now(fns)
        (h_c, g_c, st_c), (h_g, g_g, st_g) = out["cpu"], out[DEVICE]
        check(len(h_g.seconds) == rounds + 1, f"(a) {agg}: not the host loop")
        for k, (a, b) in enumerate(zip(h_c.selected, h_g.selected)):
            check(np.array_equal(a, b), f"(a) {agg}: round {k} selected "
                                        f"{list(b)} on the card, {list(a)} "
                                        "on the CPU")
        for col in ("faults", "strikes"):
            check(np.array_equal(getattr(st_c, col), getattr(st_g, col)),
                  f"(a) {agg}: {col} {getattr(st_g, col)} on the card, "
                  f"{getattr(st_c, col)} on the CPU")
        for name in ("T_k", "E_k"):
            a, b = getattr(h_c, name), getattr(h_g, name)
            check(all(math.isclose(x, y, rel_tol=2e-3) for x, y in zip(a, b)),
                  f"(a) {agg}: {name} {b} on the card, {a} on the CPU")
        err = float((g_c - g_g).abs().max())
        check(err <= 1e-4, f"(a) {agg}: global row differs by {err}")
        check(bool(torch.isfinite(g_g).all()), f"(a) {agg}: non-finite row")
        print(f"  (a) {agg}, {rounds} host-loop rounds: selections, faults "
              f"{st_g.faults.astype(int).tolist()} and strikes "
              f"{st_g.strikes.astype(int).tolist()} equal; global row "
              f"max_abs_err={err:.3e} (tol 1e-4); T_k/E_k within rtol 2e-3;"
              f" card launches {counts}")
        if agg.startswith("clipnorm"):
            check(counts["flat_aggregate"] == rounds + 1,
                  f"(a) clipnorm: {counts['flat_aggregate']} folds through "
                  f"the kernel, not {rounds + 1}")
            launches = counts
    return launches


def _replay_turns(torch, progs, reps=3):
    """Median wall [ms] of synchronised replays, the programs in turns
    (``progs``: name → (program, replay args))."""
    import numpy as np
    walls = {name: [] for name in progs}
    order = list(progs) + list(progs)[::-1]
    for _ in range(reps):
        for name in order:
            prog, kw = progs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog.replay(**kw)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in walls.items()}


def faults_traced_phase(torch, rounds=FAULTS_ROUNDS):
    """(b) ``ExperimentSpec(faults="outage:0.1,corrupt:0.05,byzantine:0.1",
    quarantine_after=2, aggregator="trimmed:0.2")``: the device-resident
    run (one captured round, the fault draw a graph input) against the
    host loop from the same seed, ``rounds`` rounds: accuracy, the global
    row, the selections and the fault and strike counts bit for bit. A
    second run counts host syncs (0); the faulty replay and
    ``ExperimentSpec()``'s beside it in turns, each profiled; the path's
    kernel launches from a profiled run."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.core.faults import draw_fault_masks

    spec = ExperimentSpec(**FAULTS_FULL, aggregator="trimmed:0.2")
    fns = kernel_fns()
    traced = build_experiment(spec, device=DEVICE)
    host = build_experiment(spec, device=DEVICE)
    t0 = time.perf_counter()
    h_t = traced.run(rounds=rounds)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    check(h_t.seconds == [], "(b) run() did not take the device-resident "
                             "path")
    h_h = host._run_host(None, rounds, 0.0)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(h_t.selected, h_h.selected)):
        check(np.array_equal(a, b), f"(b) round {k}: traced {list(a)}, host "
                                    f"loop {list(b)}")
    for name in ("accuracy", "T_k", "E_k", "band_mhz"):
        check(getattr(h_t, name) == getattr(h_h, name),
              f"(b) {name}: traced {getattr(h_t, name)}, host loop "
              f"{getattr(h_h, name)}")
    check(bool(torch.equal(traced.global_vec, host.global_vec)),
          "(b) the global rows differ")
    for col in ("faults", "strikes"):
        check(np.array_equal(getattr(traced.stats, col),
                             getattr(host.stats, col)),
              f"(b) {col}: traced {getattr(traced.stats, col)}, host loop "
              f"{getattr(host.stats, col)}")
    check(bool(torch.isfinite(traced.global_vec).all()), "(b) non-finite "
                                                         "row")
    prog = single_program(traced)
    check(prog.graph is not None and prog.ph.faults_on,
          "(b) the faulty round was not captured")
    print(f"  (b) {spec.faults}, quarantine_after=2, trimmed:0.2, {rounds} "
          f"rounds: traced ≡ host loop bit for bit (accuracy "
          f"{[round(a, 4) for a in h_t.accuracy]}, global row, selections, "
          f"faults {traced.stats.faults.astype(int).tolist()}, strikes "
          f"{traced.stats.strikes.astype(int).tolist()}); first traced run "
          f"{first_ms:.1f} ms, capture {prog.capture_ms:.1f} ms")

    # the fault-free ExperimentSpec() beside it, its round captured
    free = build_experiment(ExperimentSpec(), device=DEVICE)
    free.run(rounds=1)
    fprog = single_program(free)
    check(fprog.graph is not None, "(b) the fault-free round was not "
                                   "captured")

    # a second run of each from its seed (the graph cached): host syncs
    # from the initial round to the last replay
    again = build_experiment(spec, device=DEVICE)
    for name, p, s in (("faulty", prog, spec), ("fault-free", fprog,
                                                 ExperimentSpec())):
        exp = again if p is prog else build_experiment(s, device=DEVICE)
        state, inputs = exp.traced_state(), exp.traced_inputs()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = p(state, *inputs, draws=exp.draws, rounds=rounds,
                        with_init=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message).lower()]
        print(f"  (b) a second {name} run (graph cached), the initial round "
              f"and {rounds} replays: host syncs {len(syncs)}"
              f"{' ' + syncs[0][:120] if syncs else ''}")
        check(not syncs, f"(b) the {name} traced run waited for the card")
        if p is prog:
            check(res.rounds.accuracy.cpu().tolist() == h_t.accuracy[1:],
                  "(b) a second faulty run from the same seed gave other "
                  "accuracies")
    batch = again.draws.batch_indices(prog.pad, spec.local_iters,
                                      spec.batch_size, spec.samples_per_client)
    fault = draw_fault_masks(spec.faults, (prog.pad,), again.draws)
    prog.load(again.traced_state(), again.traced_inputs())
    fprog.load(free.traced_state(), free.traced_inputs())
    ms = _replay_turns(torch, {"faulty": (prog, dict(batch_idx=batch,
                                                      fault=fault)),
                               "free": (fprog, dict(batch_idx=batch))})
    prof = {}
    for name, p, kw in (("faulty", prog, dict(fault=fault)),
                        ("free", fprog, {})):
        n_dev, busy, inside, _, kept, window = profile_replay(
            torch, p, batch, **kw)
        prof[name] = dict(device_launches=n_dev, busy_ms=busy,
                          window_ms=window, idle=idle_share(busy, window),
                          inside=inside, replay_ms=ms[name])
        print(f"  (b) {name} replay: {ms[name]:.1f} ms (median of 6, in "
              f"turns, synchronised), {n_dev} device launches, {busy:.2f} ms "
              f"busy in a window of {window:.2f} ms: idle share "
              f"{idle_share(busy, window):.4f}; FL kernels inside {inside} "
              f"(marks kept {kept[0]} and {kept[1]})")
    free_n = prof["free"]["device_launches"]
    diff = free_n - FREE_REPLAY_LAUNCHES
    print(f"  (b) the fault-free replay's launches {free_n} against PERF.md's "
          f"{FREE_REPLAY_LAUNCHES} (call 19b): {diff:+d}"
          + (" = the selection's NaN-last top-k key (+"
             f"{TOPK_KEY_LAUNCHES})" if diff == TOPK_KEY_LAUNCHES else
             f", not the top-k key's +{TOPK_KEY_LAUNCHES} alone")
          + f"; the faulty replay's {prof['faulty']['device_launches']} "
            f"({prof['faulty']['device_launches'] - free_n:+d}: trimmed's "
            "sort in place of the fold kernel, the fault arms, the guard "
            "and the counts)")
    # trimmed:0.2 folds by a sort: no fold kernel; one divergence each
    check(prof["faulty"]["inside"] == {"flat_aggregate": 0,
                                       "pairwise_l2": 1}
          and prof["free"]["inside"] == {"flat_aggregate": 1,
                                         "pairwise_l2": 1},
          f"(b) the replays launched {prof['faulty']['inside']} (faulty) "
          f"and {prof['free']['inside']} (fault-free)")

    third = build_experiment(spec, device=DEVICE)
    state, inputs = third.traced_state(), third.traced_inputs()
    launches, wrapped = path_launches(torch, fns, lambda: prog(
        state, *inputs, draws=third.draws, rounds=rounds, with_init=True),
        rounds, "(b) the faulty device-resident path")
    hold_path_launches(launches, wrapped, prof["faulty"]["inside"], rounds,
                       "(b) the faulty device-resident path",
                       replayed=("pairwise_l2",))
    return launches, prof


def deadline_phase(torch, rounds=3):
    """(c) ``ExperimentSpec(aggregator="fedavgm:0.9")`` traced, then a
    deadline on each side of the rounds' T*: at twice the largest T_k
    nothing drops and the run is the deadline-free run bit for bit (a
    deadline takes no draw); at a thousandth of the least every round is
    the all-failed no-op — the row and the momentum pass through."""
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.utils.trees import flatten_vector
    base_spec = ExperimentSpec(aggregator="fedavgm:0.9")
    base = build_experiment(base_spec, device=DEVICE)
    h0 = base.run(rounds=rounds)
    T_max, T_min = max(h0.T_k[1:]), min(h0.T_k[1:])
    above = build_experiment(base_spec.replace(faults=f"deadline:{2 * T_max}"),
                             device=DEVICE)
    h1 = above.run(rounds=rounds)
    for name in ("accuracy", "T_k", "E_k", "band_mhz"):
        check(getattr(h1, name) == getattr(h0, name),
              f"(c) above T*: {name} {getattr(h1, name)}, without a "
              f"deadline {getattr(h0, name)}")
    for a, b in zip(h0.selected, h1.selected):
        check(list(a) == list(b), "(c) above T*: other selections")
    check(bool(torch.equal(above.global_vec, base.global_vec)),
          "(c) above T*: the global row differs from the deadline-free run")
    check(above.stats.faults.sum() == 0, "(c) above T*: a dispatch dropped")
    below = build_experiment(base_spec.replace(
        faults=f"deadline:{1e-3 * T_min}"), device=DEVICE)
    below.initial_round()
    g0 = below.global_vec.clone()
    v0 = flatten_vector(below.flat_spec, below.aggregator._opt.v).clone()
    h2 = below.run(rounds=rounds, include_initial_round=False)
    check(h2.seconds == [], "(c) below T*: not the device-resident run")
    check(bool(torch.equal(below.global_vec, g0)),
          "(c) below T*: the global row moved")
    check(bool(torch.equal(flatten_vector(below.flat_spec,
                                          below.aggregator._opt.v), v0)),
          "(c) below T*: the momentum moved")
    want = rounds * base_spec.devices_per_round
    check(below.stats.faults.sum() == want,
          f"(c) below T*: {below.stats.faults.sum()} drops, not {want}")
    print(f"  (c) T* over {rounds} rounds {T_min:.6f}–{T_max:.6f} s: a "
          f"deadline of {2 * T_max:.6f} s drops nothing and is the "
          f"deadline-free run bit for bit; one of {1e-3 * T_min:.3e} s drops "
          f"all {want} dispatches, the row and the momentum unchanged "
          f"(accuracy {[round(a, 4) for a in h2.accuracy]})")


def faults_async_phase(torch, ticks=3):
    """(d) 200 clients, ``fedbuff:2:0.5``, ``outage:0.2,corrupt:0.3``,
    quarantine after 2 strikes, churn 0.05/0.1: the dense tick (captured)
    against the paged store's four pieces, ``ticks`` ticks without the
    initial round: the history, the global row and every scheduler
    column of the stats table (the counts included) bit for bit."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_experiment
    spec = ExperimentSpec(**FAULTS_ASYNC)
    runs = {}
    for name, s in (("dense", spec),
                    ("paged", spec.replace(store="paged", k_max=200,
                                           div_refresh_every=1))):
        exp = preset_clusters(build_experiment(s, device=DEVICE))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = exp.run(rounds=ticks, include_initial_round=False)
        torch.cuda.synchronize()
        runs[name] = (exp, h, (time.perf_counter() - t0) * 1e3)
    (d, h_d, d_ms), (p, h_p, p_ms) = runs["dense"], runs["paged"]
    for k, (a, b) in enumerate(zip(h_d.selected, h_p.selected)):
        check(np.array_equal(a, b), f"(d) tick {k}: paged {list(b)}, dense "
                                    f"{list(a)}")
    for name in ("accuracy", "T_k", "E_k", "band_mhz", "participation",
                 "staleness", "active"):
        check(getattr(h_d, name) == getattr(h_p, name),
              f"(d) {name}: dense {getattr(h_d, name)}, paged "
              f"{getattr(h_p, name)}")
    check(bool(torch.equal(d.global_vec, p.global_vec)),
          "(d) the global rows differ")
    for col in SCHED_COLUMNS:
        check(np.array_equal(getattr(d.stats, col), getattr(p.stats, col)),
              f"(d) the stats column {col} differs")
    check(d.stats.faults.sum() > 0, "(d) no fault was injected")
    print(f"  (d) dense tick ≡ paged pieces over {ticks} ticks bit for bit "
          f"(history, participation {h_p.participation}, global row, "
          f"{'/'.join(SCHED_COLUMNS)}; faults {int(d.stats.faults.sum())}, "
          f"strikes {int(d.stats.strikes.sum())}); dense {d_ms:.1f} ms "
          f"(capture included), paged {p_ms:.1f} ms")


def _same_resumed(torch, full, h_full, res, h_res, what):
    import numpy as np
    for name in ("accuracy", "T_k", "E_k", "band_mhz", "participation",
                 "staleness", "active"):
        check(getattr(h_full, name) == getattr(h_res, name),
              f"(e) {what}: {name} {getattr(h_res, name)} resumed, "
              f"{getattr(h_full, name)} uninterrupted")
    for a, b in zip(h_full.selected, h_res.selected):
        check(np.array_equal(a, b), f"(e) {what}: other selections")
    check(bool(torch.equal(full.global_vec, res.global_vec)),
          f"(e) {what}: the global rows differ")
    for col in full.stats._fields:
        check(np.array_equal(getattr(full.stats, col),
                             getattr(res.stats, col)),
              f"(e) {what}: the stats column {col} differs")


def resume_phase(torch, tmp, rounds=6, cut=3):
    """(e) Kill and resume on three host loops: ``rounds`` rounds (ticks)
    uninterrupted; ``cut`` with a snapshot; a fresh experiment loads it
    and runs the rest — the global row, the history and every stats
    column bit for bit. The dense synchronous host loop and the paged
    loop at ``ExperimentSpec()``'s width with (b)'s faults, the paged
    asynchronous loop with (d)'s settings. Returns the dense resumed
    run's kernel launches and each loop's write/read ms and MiB."""
    import os
    from repro_torch.api import ExperimentSpec, build_experiment
    fns = kernel_fns()
    loops = (
        ("dense host loop", ExperimentSpec(**FAULTS_FULL), 2.0, False),
        ("paged loop", ExperimentSpec(**FAULTS_FULL, store="paged",
                                      div_refresh_every=1), None, False),
        ("paged asynchronous loop", ExperimentSpec(
            **FAULTS_ASYNC, store="paged", k_max=200, div_refresh_every=1),
         None, True))
    out, launches = {}, None
    for what, spec, target, preset in loops:
        d = os.path.join(tmp, what.replace(" ", "_"))

        def build():
            exp = build_experiment(spec, device=DEVICE)
            return preset_clusters(exp) if preset else exp
        full = build()
        h_full = full.run(rounds=rounds, target_accuracy=target,
                          include_initial_round=not preset)
        part = build()
        part.run(rounds=cut, target_accuracy=target,
                 include_initial_round=not preset, checkpoint_every=cut,
                 checkpoint_dir=d, checkpoint_spec=spec.to_dict())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        part.save_checkpoint(os.path.join(tmp, "timed"), cut)
        write_ms = (time.perf_counter() - t0) * 1e3
        snap = os.path.join(d, "round_%06d" % cut)
        mib = sum(os.path.getsize(os.path.join(snap, f))
                  for f in os.listdir(snap)) / 2 ** 20
        res = build_experiment(spec, device=DEVICE)
        t0 = time.perf_counter()
        rnd, hist = res.load_checkpoint(d, expected_spec=spec.to_dict())
        torch.cuda.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        check(rnd == cut, f"(e) {what}: resumed at {rnd}")
        zero_counts(fns)
        h_res = res.run(rounds=rounds - cut, include_initial_round=False,
                        target_accuracy=target, checkpoint_offset=rnd,
                        history=hist)
        torch.cuda.synchronize()
        counts = counts_now(fns)
        _same_resumed(torch, full, h_full, res, h_res, what)
        out[what] = dict(write_ms=write_ms, read_ms=read_ms, mib=mib)
        if launches is None:
            launches = counts
        print(f"  (e) {what}: {rounds} uninterrupted ≡ {cut} + snapshot + a "
              f"fresh experiment + {rounds - cut} bit for bit (global row, "
              f"history, every stats column; faults "
              f"{int(full.stats.faults.sum())}, strikes "
              f"{int(full.stats.strikes.sum())}); snapshot {mib:.2f} MiB, "
              f"write {write_ms:.1f} ms, read {read_ms:.1f} ms; the resumed "
              f"run's launches {counts}")
    return launches, out


def nan_fold_row(torch, timer):
    """(f) ``flat_aggregate`` at a faulty round's fold, [10, 113744] with
    3 NaN rows at weight 0: finite, bit for bit the fold of the 7 live
    rows alone; its ms against the bound of the live rows' bytes at 3.35
    TB/s, the plain version's and ``torch.mv``'s (time only: it gives NaN
    there)."""
    from repro_torch.kernels.flat_aggregate import (flat_aggregate,
                                                    flat_aggregate_plain)
    n, p, dead = 10, P_MNIST, (1, 4, 8)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    flat = torch.randn((n, p), generator=gen, device=DEVICE)
    w = torch.rand((n,), generator=gen, device=DEVICE) + 0.1
    for i in dead:
        flat[i] = float("nan")
        w[i] = 0.0
    w = w / w.sum()
    live = torch.tensor([i for i in range(n) if i not in dead],
                        device=DEVICE)
    got = flat_aggregate(flat, w)
    alone = flat_aggregate(flat[live].contiguous(), w[live].contiguous())
    want = flat_aggregate_plain(flat, w)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "(f) non-finite fold")
    check(bool(torch.equal(got, alone)), "(f) the fold with NaN rows at "
                                         "weight 0 is not the live rows' "
                                         "fold bit for bit")
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **AGG_TOL))
    check(ok, f"(f) disagrees with its plain version: {err}")
    k = n - len(dead)
    b_ms, b_by = bound(k * p * 4 + n * 4 + p * 4, 2 * k * p)
    r = dict(shape=[n, p], nan_rows=len(dead), max_abs_err=err, ok=ok,
             device_launches_per_call=device_launches(
                 torch, lambda: flat_aggregate(flat, w)),
             ms=timer(lambda: flat_aggregate(flat, w)),
             plain_ms=timer(lambda: flat_aggregate_plain(flat, w)),
             library_ms=timer(lambda: torch.mv(flat.t(), w)),
             bound_ms=b_ms, bound_by=b_by,
             bound_rate=rate_name(FP32_FLOP_PER_S))
    print(f"  (f) flat_aggregate [{n},{p}] with {len(dead)} NaN rows at "
          f"weight 0: finite, ≡ the {k} live rows' fold bit for bit; "
          f"max_abs_err={err:.3e} (tol 2e-5) ms={r['ms']:.4f} "
          f"plain_ms={r['plain_ms']:.4f} library_ms(torch.mv, NaN out: time "
          f"only)={r['library_ms']:.4f} bound_ms={b_ms:.5f} ({b_by}, "
          f"3.35 TB/s) device_launches/call={r['device_launches_per_call']}")
    return r


def faults_phase(torch, rows):
    """13. (a)–(f); ``rows``: phase 2's table, which gains (f)'s row."""
    import tempfile
    by_path = {}
    print("  (a) CPU and card agree: a tiny faulty host loop, trimmed and "
          "clipnorm")
    by_path["faulty host loop, clipnorm (phase 13a)"] = faults_agreement(
        torch)
    torch.cuda.empty_cache()
    print(f"  (b) {FAULTS_FULL}, trimmed:0.2: traced against the host loop, "
          f"{FAULTS_ROUNDS} rounds")
    launches, prof = faults_traced_phase(torch)
    by_path["faulty device-resident run (phase 13b)"] = launches
    torch.cuda.empty_cache()
    print("  (c) a deadline on both sides of the rounds' T*")
    deadline_phase(torch)
    torch.cuda.empty_cache()
    print("  (d) 200 clients, faults under churn: dense tick against the "
          "paged pieces")
    faults_async_phase(torch)
    torch.cuda.empty_cache()
    print("  (e) kill and resume: the dense host loop, the paged loop, the "
          "paged asynchronous loop")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        launches, snaps = resume_phase(torch, tmp)
    by_path["resumed dense host loop (phase 13e)"] = launches
    torch.cuda.empty_cache()
    print("  (f) flat_aggregate with NaN rows at weight 0")
    timer = Timer(torch)
    rows["flat_aggregate"].append(nan_fold_row(torch, timer))
    del timer
    torch.cuda.empty_cache()
    return by_path, dict(traced=prof, snapshots=snaps)


# ---------------------------------------------------------------------------
# phase 14: the entry points
# ---------------------------------------------------------------------------

QUICKSTART = ["--dataset", "fashion", "--selection", "divergence",
              "--allocator", "sao"]            # README.md's Quickstart
LM_ARCHS = {"tinyllama-1.1b": "flash_attention", "mamba2-130m": "ssd_scan"}
LM_LANES = dict(clients=10, devices_per_round=4, num_clusters=4,
                local_iters=2, batch_size=8, train_samples=160,
                test_samples=64, samples_per_client=16, rounds=1, cohort=2)
DECODE_TOL = 1e-4       # decode logits against forward's, and card vs CPU
SERVE = dict(batch=4, prompt=8, gen=32)
TRAIN = dict(steps=5, batch=8, seq=128)


def stdout_of(fn, argv):
    """``fn(argv)``'s return value and what it printed."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue()


def counted(torch, fn):
    """``fn()`` with every kernel's count set to 0 just before it and read
    just after (what the wrappers launched: eagerly, or into a graph being
    captured; a graph's replays count nothing)."""
    fns = kernel_fns()
    for k in fns.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in fns.items()}


def fl_sim_phase(torch, tmp):
    """(a) ``repro_torch.launch.fl_sim.main`` in-process: the Quickstart's
    flags with ``--rounds 3`` print what ``run_spec(ExperimentSpec(
    dataset="fashion", rounds=3))`` gives, bit for bit; ``--dump-spec``
    round-trips; 4 rounds with a snapshot a round, the snapshots after
    round 2 removed (the run killed there), then ``--resume``: the
    uninterrupted run bit for bit; ``--cohort 2 --rounds 2`` runs. The FL
    kernels' launches come from the Quickstart run alone."""
    import shutil
    from repro_torch.api import ExperimentSpec
    from repro_torch.launch import fl_sim

    spec = ExperimentSpec(dataset="fashion", rounds=3)
    argv = QUICKSTART + ["--rounds", "3"]
    check(fl_sim.spec_from_args(fl_sim.build_parser().parse_args(argv))
          == spec, "the Quickstart's flags resolve to another spec")
    t0 = time.perf_counter()
    (_, text), launches = counted(torch, lambda: stdout_of(fl_sim.main,
                                                           argv))
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exp, hist, ari = fl_sim.run_spec(spec)
    want = fl_sim.format_result(fl_sim.run_result(spec, hist, ari))
    check(hist.seconds == [], "run_spec did not take the device-resident run")
    check(text.strip() == want, f"fl_sim printed\n{text}\nrun_spec gives\n"
                                f"{want}")
    print(f"  fl_sim {' '.join(argv)}: {cli_s:.1f} s, printed the same JSON "
          f"as run_spec(ExperimentSpec(dataset='fashion', rounds=3)) "
          f"({time.perf_counter() - t0:.1f} s) bit for bit:")
    for line in text.strip().splitlines():
        print(f"    {line}")
    print(f"  launches in the fl_sim run (the initial round's and the "
          f"captured round's): {launches}")
    for name in ("flat_aggregate", "pairwise_l2"):
        check(launches[name] > 0, f"fl_sim: {name} was not launched")
    del exp

    _, dumped = stdout_of(fl_sim.main, argv + ["--dump-spec"])
    check(ExperimentSpec.from_json(dumped) == spec, "--dump-spec: another "
                                                    "spec")
    path = tmp / "spec.json"
    path.write_text(dumped)
    _, again = stdout_of(fl_sim.main, ["--spec", str(path), "--dump-spec"])
    check(again == dumped, "--dump-spec does not round-trip through --spec")
    print("  --dump-spec round-trips through --spec")

    ck, full, res = tmp / "ck", tmp / "full.jsonl", tmp / "res.jsonl"
    t0 = time.perf_counter()
    stdout_of(fl_sim.main, QUICKSTART + [
        "--rounds", "4", "--checkpoint-every", "1", "--checkpoint-dir",
        str(ck), "--out", str(full)])
    for name in ("round_000003", "round_000004"):
        shutil.rmtree(ck / name)
    _, text = stdout_of(fl_sim.main, ["--resume", str(ck), "--out",
                                      str(res)])
    a, b = json.loads(full.read_text()), json.loads(res.read_text())
    for key in ("accuracy", "total_T_s", "total_E_J", "clustering_ari",
                "spec"):
        check(a[key] == b[key], f"resumed {key} {b[key]}, uninterrupted "
                                f"{a[key]}")
    print(f"  4 rounds with --checkpoint-every 1, killed after round 2, "
          f"--resume: the uninterrupted run bit for bit (accuracy "
          f"{b['accuracy']}; {time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    _, text = stdout_of(fl_sim.main, QUICKSTART + ["--rounds", "2",
                                                   "--cohort", "2"])
    got = json.loads(text)
    check(got["seeds"] == [0, 1] and all(
        0.0 <= x <= 1.0 for x in got["final_accuracy_per_seed"]),
          f"--cohort 2: {got}")
    print(f"  --cohort 2 --rounds 2: final accuracy by seed "
          f"{got['final_accuracy_per_seed']}, ARI "
          f"{got['clustering_ari_per_seed']} "
          f"({time.perf_counter() - t0:.1f} s)")
    return launches


def lm_lanes_phase(torch, arch):
    """(b) LoRA-LM lanes at the published width: ``build_cohort`` of 2
    seeds over ``arch`` (N = 10, S = 4, c = 4, L = 2, batch 8), the initial
    round and one replay of ONE captured round for both lanes, with the
    frozen base shared beside them. A first run captures; a second runs
    under ``transfer_guard`` (0 host syncs) with the wrappers' counts (its
    eager initial round) and must repeat it. Each lane is its seed's
    single traced run bit for bit. The cohort's replay against one
    seed's (medians, in turns), one cohort replay profiled: the four
    kernels inside it."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build_cohort, build_experiment
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.registry import register_workload

    name = f"{arch}-published"
    register_workload(name, lambda: lm.LMConfig(model=get_config(arch)))
    spec = ExperimentSpec(model=name, **LM_LANES)
    what = f"{arch} LoRA cohort of 2"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = build_cohort(spec)
    first = runner.run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    prog = runner.program
    check(prog.graph is not None and prog.lanes == 2,
          f"{what}: the round was not captured as one graph for both lanes")
    t0 = time.perf_counter()
    ch, wrapped = counted(torch, lambda: runner.run(transfer_guard=True))
    guarded_s = time.perf_counter() - t0
    check(runner.program is prog, f"{what}: the second run captured again")
    check(same_history(first, ch), f"{what}: two runs from the same seeds "
                                   "differ")
    p = runner.experiments[0].global_vec.numel()
    print(f"  {what}: P_adapter={p}; build + first run (capture included) "
          f"{first_s:.1f} s, capture {prog.capture_ms:.1f} ms; a second run "
          f"under transfer_guard (0 host syncs) {guarded_s:.1f} s, equal to "
          f"the first; its initial round launched {wrapped}")
    for i, seed in enumerate(ch.seeds):
        single = build_experiment(spec.replace(seed=seed, cohort=1))
        h = single.run()
        hi, lane = ch.history(i), runner.experiments[i]
        check(h.seconds == [], f"{what}: a single run took the host loop")
        same = (all(np.array_equal(a, b)
                    for a, b in zip(hi.selected, h.selected))
                and list(hi.accuracy) == list(h.accuracy)
                and list(hi.T_k) == list(h.T_k)
                and list(hi.E_k) == list(h.E_k)
                and torch.equal(lane.global_vec, single.global_vec)
                and torch.equal(lane.client_plane, single.client_plane)
                and np.array_equal(lane.cluster_labels,
                                   single.cluster_labels))
        d_row = float((lane.global_vec - single.global_vec).abs().max())
        check(same, f"{what}: lane {i} (seed {seed}) is not its seed's "
                    f"single run bit for bit (global row differs by "
                    f"{d_row})")
    print(f"  every lane is its seed's single traced run bit for bit "
          f"(selections, accuracy, T_k, E_k, global row, client plane, "
          f"labels); accuracy by lane {ch.final_accuracy.tolist()}")

    single_prog = single_program(single)
    batch, _ = lane_draws(torch, prog, runner.experiments)
    batch1, _ = lane_draws(torch, single_prog, [single])
    walls = {"single": [], "cohort": []}
    for _ in range(2):
        for key, fn in (("single", lambda: single_prog.replay(batch1)),
                        ("cohort", lambda: prog.replay(batch)),
                        ("cohort", lambda: prog.replay(batch)),
                        ("single", lambda: single_prog.replay(batch1))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[key].append((time.perf_counter() - t0) * 1e3)
    ms = {k: float(np.median(v)) for k, v in walls.items()}
    n_dev, busy, _, by_name, kept, window = profile_replay(torch, prog,
                                                           batch)
    inside = {k: sum(n for fn_name, (n, _) in by_name.items()
                     if DEVICE_KERNEL[k] in fn_name) for k in KERNELS}
    launches = {k: wrapped[k] + inside[k] for k in KERNELS}
    print(f"  replay wall (synchronised, median of {len(walls['cohort'])}, "
          f"in turns): cohort of 2 {ms['cohort']:.1f} ms, one seed "
          f"{ms['single']:.1f} ms ({ms['cohort'] / ms['single']:.2f}x)")
    print(f"  one profiled cohort replay: {n_dev} device launches, "
          f"{busy:.2f} ms busy of a {window:.2f} ms device window (idle "
          f"share {idle_share(busy, window):.4f}; marks kept {kept}); the "
          f"kernels inside it {inside}; the path (initial round + 1 "
          f"replay): {launches}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k in ("flat_aggregate", "pairwise_l2", LM_ARCHS[arch]):
        check(inside[k] > 0, f"{what}: {k} did not run inside the replay")
        check(wrapped[k] > 0, f"{what}: {k} was not launched in the initial "
                              "round")
    del runner, single, single_prog
    lm.base_params.cache_clear()
    torch.cuda.empty_cache()
    return launches, dict(replay_ms=ms["cohort"], single_ms=ms["single"],
                          device_launches=n_dev)


def lm_params(torch, arch, seed=0):
    """``arch``'s published config and random weights on the card, drawn as
    ``launch.serve`` / ``launch.train`` draw them."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config(arch)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return cfg, init_model(cfg, gen, DEVICE)


def serve_phase(torch, arch, own=None):
    """(c) ``repro_torch.launch.serve.main`` at the published width: batch
    4, an 8-token prompt, 32 tokens, greedy (its tok/s line). On the same
    weights and prompts (and, for an encoder-decoder, the CLI's 32 frames
    of ``src_embeds``, through ``encode_memory`` into the cache): the
    decode logits of the prompt (``decode_step`` token by token) against
    the full-sequence ``forward`` (which runs ``own``: ``flash_attention``
    / ``ssd_scan``) within 1e-4; the engine's tokens equal the CLI's; the
    first token is ``forward``'s argmax wherever the top two logits are
    more than twice the tolerance apart. An encoder-decoder's encoder
    launches are counted apart (``enc_counts``)."""
    from repro_torch.launch import serve
    from repro_torch.models.transformer import encode_memory, forward
    from repro_torch.serve import ServeEngine

    own = own or LM_ARCHS[arch]
    b, sp, gen_n = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (out, text), cli_counts = counted(torch, lambda: stdout_of(serve.main, [
        "--arch", arch, "--batch", str(b), "--prompt-len", str(sp),
        "--gen", str(gen_n)]))
    print(f"  {text.splitlines()[0]} (launch.serve; kernel launches "
          f"{cli_counts}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    cfg, params = lm_params(torch, arch)
    prompts = torch.randint(0, cfg.vocab_size, (b, sp), device=DEVICE,
                            generator=torch.Generator(device=DEVICE)
                            .manual_seed(1))
    eng = ServeEngine(cfg, params, max_len=sp + gen_n + 1)
    cache = eng.new_cache(b)
    batch, kw, enc_counts = {"tokens": prompts}, {}, None
    if cfg.is_encoder_decoder:
        src = torch.randn((b, 32, cfg.d_model), device=DEVICE,
                          generator=torch.Generator(device=DEVICE)
                          .manual_seed(2)) * 0.1
        batch["src_embeds"] = kw["src_embeds"] = src
        with torch.no_grad():
            (cache["cross_k"], cache["cross_v"]), enc_counts = counted(
                torch, lambda: encode_memory(cfg, params, batch))
    dec = torch.cat([eng.step(cache, prompts[:, t:t + 1])
                     for t in range(sp)], dim=1)
    with torch.no_grad():
        full, counts = counted(torch, lambda: forward(cfg, params, batch)[0])
    err = float((dec - full).abs().max())
    check(counts[own] > 0, f"serve: forward did not launch {own}")
    check(err <= DECODE_TOL, f"{arch}: decode logits differ from forward's "
                             f"by {err} (tol {DECODE_TOL})")
    t0 = time.perf_counter()
    toks = eng.generate(prompts, gen_n, **kw)
    dt = time.perf_counter() - t0
    check((toks == out).all(), f"{arch}: the engine's tokens differ from "
                               "the CLI's")
    top2 = torch.topk(full[:, -1], 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1] > 2 * DECODE_TOL).cpu().numpy()
    first = torch.argmax(full[:, -1], dim=-1).cpu().numpy()
    check((first[clear] == out[clear, 0]).all(),
          f"{arch}: greedy's first token is not forward's argmax")
    print(f"  decode logits of the {sp}-token prompt against forward "
          f"(launches {counts}): max_abs_err={err:.3e} (tol {DECODE_TOL}); "
          f"the engine's tokens are the CLI's; first token = forward's "
          f"argmax on {int(clear.sum())} of {b} rows with a clear top; "
          f"generate again {dt * 1e3:.1f} ms = {b * gen_n / dt:.1f} tok/s")
    del params, eng, cache
    torch.cuda.empty_cache()
    return dict(counts, **{"tok_per_s": b * gen_n / dt, "decode_err": err,
                           "enc_counts": enc_counts})


def train_phase(torch, arch, tmp, own=None):
    """(d) ``repro_torch.launch.train.main`` at the published width: 5
    AdamW steps of batch 8 × 128 tokens, fp32 (an encoder-decoder's zero
    frames beside them); the loss finite, s/step (the logged wall clock
    from step 1 to 4) and the peak device memory. Then, at the smoke
    config, one step on the card from the same parameters and batch as one
    on the CPU: loss and parameters within 1e-4."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_model
    from repro_torch.train.train_step import make_train_step

    own = own or LM_ARCHS[arch]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (logger, text), launches = counted(torch, lambda: stdout_of(
        train.main, ["--arch", arch, "--steps", str(TRAIN["steps"]),
                     "--batch", str(TRAIN["batch"]), "--seq",
                     str(TRAIN["seq"]), "--log-csv",
                     str(tmp / f"{arch}.csv")]))
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss, wall = logger.history["loss"], logger.history["wall_s"]
    check(len(loss) == TRAIN["steps"] and all(map(math.isfinite, loss)),
          f"train {arch}: losses {loss}")
    s_step = (wall[-1] - wall[1]) / (len(wall) - 2)
    check(launches[own] > 0, f"train {arch}: {own} was not launched")
    print(f"  launch.train --arch {arch} (published width): {TRAIN['steps']} "
          f"steps of {TRAIN['batch']}x{TRAIN['seq']} in {total:.1f} s; "
          f"losses {[round(x, 4) for x in loss]}; {s_step:.3f} s/step "
          f"(steps 2-{TRAIN['steps']}); peak allocated {peak:.2f} GiB; "
          f"launches {launches}")

    cfg = get_smoke_config(arch)
    params = init_model(cfg, torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)))
    out = {}
    for dev in ("cpu", DEVICE):
        init, step = make_train_step(cfg, TrainConfig())
        p = {k: v.to(dev) for k, v in params.items()}
        batch = {"tokens": tokens.to(dev),
                 **train.make_vlm_audio_extras(cfg, 4, 32, dev)}
        new, _, m = step(p, init(p), batch)
        out[dev] = ({k: v.cpu() for k, v in new.items()}, float(m["loss"]))
    d_loss = abs(out["cpu"][1] - out[DEVICE][1])
    d_par = max(float((out["cpu"][0][k] - out[DEVICE][0][k]).abs().max())
                for k in params)
    check(d_loss <= DECODE_TOL and d_par <= DECODE_TOL,
          f"train {arch} smoke: card vs CPU loss {d_loss}, params {d_par}")
    print(f"  one smoke step card vs CPU: loss differs by {d_loss:.3e}, "
          f"parameters by {d_par:.3e} (tol {DECODE_TOL})")
    return dict(launches, s_per_step=s_step, peak_gib=peak)


def entry_points_phase(torch, tmp):
    """14. (a)–(d); returns each path's launches and the numbers kept."""
    by_path, kept = {}, {}
    t0 = time.perf_counter()
    print("  (a) fl_sim: the Quickstart, --dump-spec, resume, a cohort")
    by_path["fl_sim Quickstart (phase 14a)"] = fl_sim_phase(torch, tmp)
    print(f"  (a) took {time.perf_counter() - t0:.1f} s")
    for arch in LM_ARCHS:
        t1 = time.perf_counter()
        print(f"  (b) {arch}: LoRA lanes at the published width")
        by_path[f"{arch} LoRA cohort (phase 14b)"], kept[arch] = (
            lm_lanes_phase(torch, arch))
        print(f"  (b) took {time.perf_counter() - t1:.1f} s")
    for arch in LM_ARCHS:
        t1 = time.perf_counter()
        print(f"  (c) {arch}: serve")
        got = serve_phase(torch, arch)
        by_path[f"{arch} serve forward (phase 14c)"] = {
            k: got[k] for k in KERNELS}
        kept[arch].update(tok_per_s=got["tok_per_s"])
        print(f"  (c) took {time.perf_counter() - t1:.1f} s")
    for arch in LM_ARCHS:
        t1 = time.perf_counter()
        print(f"  (d) {arch}: train")
        got = train_phase(torch, arch, tmp)
        by_path[f"{arch} train (phase 14d)"] = {k: got[k] for k in KERNELS}
        kept[arch].update(s_per_step=got["s_per_step"],
                          peak_gib=got["peak_gib"])
        print(f"  (d) took {time.perf_counter() - t1:.1f} s")
    return by_path, kept


# ---------------------------------------------------------------------------
# phase 15: the remaining model families
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-3b-a800m"
SEAMLESS = "seamless-m4t-medium"
JAMBA = "jamba-1.5-large-398b"
NEW_ARCHS = (GRANITE, JAMBA, "minitron-8b", "mixtral-8x22b",
             "phi-3-vision-4.2b", "qwen2-1.5b", "qwen2-72b", SEAMLESS)
# granite's train step at published width, cut to 8 of its 32 layers: the
# functional AdamW peaks near 38 B a parameter (tinyllama, phase 14(d)),
# about 119 GiB for all 3.37 B of granite's
GRANITE_TRAIN_LAYERS = 8
MOE_TOL = dict(dense_fused=1e-5, dispatch=1e-4)   # against dense
FAMILY_TOL = dict(rtol=1e-5, atol=1e-5)   # card against CPU, smoke configs


def moe_layer_phase(torch):
    """(b) One granite MoE layer at published width (E = 40, top 8, d =
    1536, F = 512) on 8 × 128 tokens: ``dense_fused`` equals ``dense``
    within 1e-5; ``dispatch`` at ``capacity_factor = E / k`` (nothing
    dropped) equals it within 1e-4; the default capacity (1.25) runs and
    drops what its capacity leaves out; a second call of each equals the
    first bit for bit. Each call's time (CUDA events, L2 flushed)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config(GRANITE)
    moe = cfg.moe
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    p = {k: v[0] for k, v in L.init_moe(gen, cfg.d_model, moe, DEVICE,
                                         1).items()}
    x = torch.randn((8, 128, cfg.d_model), generator=gen, device=DEVICE)
    full = moe.num_experts / moe.top_k
    runs = {"dense": lambda: L.moe_apply_dense(p, x, moe),
            "dense_fused": lambda: L.moe_apply_dense_fused(p, x, moe),
            "dispatch": lambda: L.moe_apply_dispatch(p, x, moe,
                                                     capacity_factor=full),
            "dispatch 1.25": lambda: L.moe_apply_dispatch(p, x, moe)}
    timer = Timer(torch)
    outs, ms = {}, {}
    with torch.no_grad():
        for name, fn in runs.items():
            a, aux_a = fn()
            b, aux_b = fn()
            torch.cuda.synchronize()
            check(torch.equal(a, b) and torch.equal(aux_a, aux_b),
                  f"MoE {name}: a second call differs from the first")
            outs[name] = (a, float(aux_a))
            ms[name] = timer(fn, reps=10, warm=2)
        t = x.reshape(-1, cfg.d_model)
        _, _, topi, _ = L._route(p, t, moe)
        cap = L.moe_capacity(t.shape[0], moe)
        keep = L.dispatch_slots(topi, moe.num_experts, cap)[3]
    del timer
    dense, aux = outs["dense"]
    errs = {}
    for name, tol in MOE_TOL.items():
        errs[name] = float((outs[name][0] - dense).abs().max())
        check(errs[name] <= tol, f"MoE {name} differs from dense by "
                                 f"{errs[name]} (tol {tol})")
        check(outs[name][1] == aux, f"MoE {name}: another aux")
    check(math.isfinite(aux) and aux > 0, f"MoE aux {aux}")
    dropped = 1.0 - float(keep.float().mean())
    print(f"  granite MoE layer (E={moe.num_experts}, top {moe.top_k}, "
          f"d={cfg.d_model}, F={moe.d_ff}) on 8x128 tokens: dense_fused - "
          f"dense {errs['dense_fused']:.3e} (tol 1e-5), dispatch at "
          f"capacity E/k - dense {errs['dispatch']:.3e} (tol 1e-4); the "
          f"default capacity {cap} slots an expert drops "
          f"{dropped:.4f} of the (token, slot) pairs; each second call "
          f"equal bit for bit; aux {aux:.6f}; ms "
          f"{ {k: round(v, 4) for k, v in ms.items()} }")
    return dict(ms, dropped=dropped)


def granite_train_phase(torch):
    """(c) ``make_train_step`` over granite at published width, cut to
    ``GRANITE_TRAIN_LAYERS`` layers: 5 AdamW steps of 8 × 128 tokens
    under ``dense`` and ``dispatch``; loss, ce and aux finite with aux > 0;
    s/step (median of steps 2-5, synchronised) and the peak memory."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_model
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(GRANITE).replace(num_layers=GRANITE_TRAIN_LAYERS)
    stream = make_token_stream(cfg.vocab_size, 200_000, seed=0)
    by_impl, kept = {}, {}
    for impl in ("dense", "dispatch"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_model(cfg, torch.Generator(device=DEVICE)
                            .manual_seed(0), DEVICE)
        tc = TrainConfig(total_steps=TRAIN["steps"], warmup_steps=1)
        init, step = make_train_step(cfg, tc, moe_impl=impl, q_chunk=64,
                                     kv_chunk=64)
        state = init(params)
        batches = train.batches_from_stream(stream, TRAIN["batch"],
                                            TRAIN["seq"], 0, DEVICE)
        walls, metrics = [], []

        def run():
            nonlocal params, state
            for _ in range(TRAIN["steps"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step(params, state, next(batches))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                metrics.append({k: float(m[k]) for k in ("loss", "ce",
                                                         "aux")})

        _, launches = counted(torch, run)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(math.isfinite(v) for m in metrics for v in m.values())
              and all(m["aux"] > 0 for m in metrics),
              f"granite train ({impl}): {metrics}")
        check(launches["flash_attention"] > 0,
              f"granite train ({impl}): flash_attention was not launched")
        s_step = float(np.median(walls[1:]))
        print(f"  granite {GRANITE_TRAIN_LAYERS} of 32 layers at published "
              f"width, moe_impl={impl}: {TRAIN['steps']} AdamW steps of "
              f"{TRAIN['batch']}x{TRAIN['seq']}; loss "
              f"{[round(m['loss'], 4) for m in metrics]}, aux "
              f"{[round(m['aux'], 5) for m in metrics]}; {s_step:.3f} "
              f"s/step (median of steps 2-{TRAIN['steps']}); peak "
              f"allocated {peak:.2f} GiB; launches {launches}")
        by_impl[impl], kept[impl] = launches, dict(s_per_step=s_step,
                                                  peak_gib=peak)
        del params, state, init, step
    torch.cuda.empty_cache()
    return by_impl, kept


def jamba_phase(torch):
    """(e) jamba at its smoke config on the card (published width does not
    fit: one MoE layer alone is about 36 GiB in fp32): ``forward`` of 4 ×
    64 tokens, its ``flash_attention`` and ``ssd_scan`` launches counted
    (one a layer of each kind); decode token by token equal to ``forward``
    within 1e-4; one train step (``dispatch``) with loss and aux finite,
    aux > 0."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.transformer import (_layer_plan, decode_step,
                                                forward, init_cache,
                                                init_model)
    from repro_torch.train.train_step import make_train_step

    cfg = get_smoke_config(JAMBA)
    params = init_model(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        DEVICE)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64)), device=DEVICE)
    with torch.no_grad():
        full, launches = counted(torch, lambda: forward(
            cfg, params, {"tokens": tokens})[0])
        cache = init_cache(cfg, 4, 64, device=DEVICE)
        dec = torch.cat([decode_step(cfg, params,
                                     {"tokens": tokens[:, t:t + 1]},
                                     cache)[0] for t in range(64)], dim=1)
    mixers = [m for m, _ in _layer_plan(cfg)]
    want = {"flash_attention": mixers.count("attn"),
            "ssd_scan": mixers.count("mamba")}
    for name, n in want.items():
        check(launches[name] == n, f"jamba forward: {name} launched "
                                   f"{launches[name]} times, {n} layers")
    err = float((dec - full).abs().max())
    check(err <= DECODE_TOL, f"jamba: decode differs from forward by {err}")
    init, step = make_train_step(cfg, TrainConfig(), moe_impl="dispatch")
    _, _, m = step(params, init(params), {"tokens": tokens})
    m = {k: float(m[k]) for k in ("loss", "ce", "aux")}
    check(all(map(math.isfinite, m.values())) and m["aux"] > 0,
          f"jamba train step: {m}")
    print(f"  jamba smoke ({cfg.num_layers} layers, attention 1 in "
          f"{cfg.attn_period}, MoE 1 in {cfg.moe_period}): forward of 4x64 "
          f"launched {launches}; 64 decode steps against forward "
          f"max_abs_err={err:.3e} (tol {DECODE_TOL}); one train step "
          f"(dispatch) {m}")
    del params, cache
    return launches


def families_agreement(torch):
    """(f) Each new architecture's smoke config on the card against the
    CPU, from the same parameters and inputs (a VLM's image embeddings, an
    encoder-decoder's frames): ``forward``'s logits within rtol/atol 1e-5,
    and one train step's loss within rtol 1e-5."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.transformer import forward, init_model
    from repro_torch.train.train_step import make_train_step

    errs = {}
    for arch in NEW_ARCHS:
        cfg = get_smoke_config(arch)
        params = init_model(cfg, torch.Generator().manual_seed(0))
        rng = np.random.default_rng(1)
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (2, 32)))}
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.as_tensor(rng.normal(
                size=(2, cfg.num_image_tokens, cfg.d_model)).astype(
                    np.float32))
        if cfg.is_encoder_decoder:
            batch["src_embeds"] = torch.as_tensor(rng.normal(
                size=(2, 24, cfg.d_model)).astype(np.float32))
        got = {}
        for dev in ("cpu", DEVICE):
            p = {k: v.to(dev) for k, v in params.items()}
            b = {k: v.to(dev) for k, v in batch.items()}
            with torch.no_grad():
                logits, aux = forward(cfg, p, b)
            init, step = make_train_step(cfg, TrainConfig())
            _, _, m = step(p, init(p), b)
            got[dev] = (logits.cpu(), float(aux), float(m["loss"]))
        (l_c, a_c, s_c), (l_g, a_g, s_g) = got["cpu"], got[DEVICE]
        err = float((l_c - l_g).abs().max())
        ok = (torch.allclose(l_g, l_c, **FAMILY_TOL)
              and math.isclose(a_g, a_c, rel_tol=1e-5, abs_tol=1e-5)
              and math.isclose(s_g, s_c, rel_tol=1e-5))
        check(ok, f"{arch} smoke: card vs CPU logits {err}, aux {a_g} / "
                  f"{a_c}, loss {s_g} / {s_c}")
        errs[arch] = (err, abs(s_g - s_c))
    print(f"  card vs CPU on the smoke configs (logits max_abs_err, one "
          f"train step's |d loss|), tol 1e-5: "
          f"{ {k: tuple(f'{x:.2e}' for x in v) for k, v in errs.items()} }")


def phi3_refuses(torch):
    """phi-3-vision's head dim 96 is no template instance of
    ``flash_attention``: at its published width (one layer of 32) the
    card's forward raises the kernel's ``ValueError`` and launches
    nothing; it does not fall back."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import forward, init_model

    cfg = get_config("phi-3-vision-4.2b").replace(num_layers=1)
    params = init_model(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        DEVICE)
    tokens = torch.zeros((1, 8), dtype=torch.int64, device=DEVICE)
    fns = kernel_fns()
    before = fns["flash_attention"].launches
    try:
        with torch.no_grad():
            forward(cfg, params, {"tokens": tokens})
    except ValueError as e:
        check("head dims" in str(e), f"phi-3-vision: another error: {e}")
        print(f"  phi-3-vision at published width (head dim "
              f"{cfg.resolved_head_dim}) raises: {e}")
    else:
        fail("phi-3-vision at head dim 96 ran on the card")
    check(fns["flash_attention"].launches == before,
          "phi-3-vision: flash_attention launched")
    del params
    torch.cuda.empty_cache()


def families_phase(torch, tmp):
    """15. (a)-(f); returns each path's launches and the numbers kept."""
    from repro_torch.configs import get_config
    by_path, kept = {}, {}
    t0 = time.perf_counter()
    print(f"  (a) {GRANITE}: serve at published width")
    got = serve_phase(torch, GRANITE, own="flash_attention")
    by_path["granite serve forward (phase 15a)"] = {k: got[k]
                                                    for k in KERNELS}
    kept[GRANITE] = dict(tok_per_s=got["tok_per_s"])
    print(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    print("  (b) one granite MoE layer: dense, dense_fused, dispatch")
    kept["granite MoE layer"] = moe_layer_phase(torch)
    print(f"  (b) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    print(f"  (c) granite train, {GRANITE_TRAIN_LAYERS} of 32 layers")
    launches, kept["granite train"] = granite_train_phase(torch)
    for impl, n in launches.items():
        by_path[f"granite train {impl} (phase 15c)"] = n
    print(f"  (c) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    print(f"  (d) {SEAMLESS}: serve and train at published width")
    got = serve_phase(torch, SEAMLESS, own="flash_attention")
    enc = got["enc_counts"]
    n_enc = get_config(SEAMLESS).num_layers
    check(enc["flash_attention"] == n_enc,
          f"seamless encoder: {enc['flash_attention']} non-causal "
          f"flash_attention launches, {n_enc} layers")
    print(f"  the encoder (encode_memory) launched {enc}: one non-causal "
          f"flash_attention a layer")
    by_path["seamless encoder, non-causal (phase 15d)"] = enc
    by_path["seamless serve forward (phase 15d)"] = {k: got[k]
                                                     for k in KERNELS}
    kept[SEAMLESS] = dict(tok_per_s=got["tok_per_s"])
    got = train_phase(torch, SEAMLESS, tmp, own="flash_attention")
    by_path["seamless train (phase 15d)"] = {k: got[k] for k in KERNELS}
    kept[SEAMLESS].update(s_per_step=got["s_per_step"],
                          peak_gib=got["peak_gib"])
    print(f"  (d) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    print(f"  (e) {JAMBA} at its smoke config")
    by_path["jamba smoke forward (phase 15e)"] = jamba_phase(torch)
    print(f"  (e) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    print("  (f) card against CPU on the eight new smoke configs; "
          "phi-3-vision's head dim 96")
    families_agreement(torch)
    phi3_refuses(torch)
    print(f"  (f) took {time.perf_counter() - t1:.1f} s")
    return by_path, kept


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
    names = list(KERNELS)
    t0 = time.perf_counter()
    logs = build.build(names, ptxas_verbose=True)
    print(f"  built {names} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print(f"  phase 1 done at {time.perf_counter() - t_start:.1f} s")
    print("== 2. kernels against their plain versions")
    from repro_torch.core.fedavg import fp32_matmuls
    fp32_matmuls()
    timer = Timer(torch)
    rows = kernel_phase(torch, timer)
    del timer
    torch.cuda.empty_cache()

    print(f"  phase 2 done at {time.perf_counter() - t_start:.1f} s")
    print("== 3. CPU and card agree on tiny runs")
    agreement_phase(torch)

    print(f"  phase 3 done at {time.perf_counter() - t_start:.1f} s")
    print("== 4. main path: ExperimentSpec() on the card, 3 rounds")
    from repro_torch.api import ExperimentSpec
    exp, launches = main_path_phase(torch, ExperimentSpec())
    by_path = {"ExperimentSpec()": dict(launches)}

    print(f"  phase 4 done at {time.perf_counter() - t_start:.1f} s")
    print("== 5. where one round's time goes")
    profile_phase(torch, exp)
    del exp
    torch.cuda.empty_cache()

    # each kernel's launches come from the path that runs it: the CNN main
    # path for the FL kernels, the tinyllama / mamba2 LM runs for the others
    for arch, own in (("tinyllama-1.1b", "flash_attention"),
                      ("mamba2-130m", "ssd_scan")):
        print(f"== 6. the federated LM at full width: {arch}, 2 rounds")
        print(f"  phase 5 / 6 done at {time.perf_counter() - t_start:.1f} s")
        lm_launches, _ = lm_phase(torch, arch)
        launches[own] = lm_launches[own]
        by_path[arch] = lm_launches

    print("== 7. the paper's comparisons on the card")
    print(f"  phase 6 done at {time.perf_counter() - t_start:.1f} s")
    print("  (a) Fig. 5: every allocator on 10 devices at B = 20 MHz")
    fig5_phase(torch)
    print("  (b) Algorithm 6, the shared transmit power")
    power_phase(torch)
    print("  (c) ExperimentSpec(): one round per selector and allocator")
    _, comparison_launches = comparison_rounds_phase(torch)
    by_path["comparisons (phase 7c)"] = comparison_launches
    torch.cuda.empty_cache()
    print("  (d) rra: 5 host-loop rounds with and without the solves' "
          "graphs")
    varying_set_phase(torch)
    torch.cuda.empty_cache()

    print(f"  phase 7 done at {time.perf_counter() - t_start:.1f} s")
    print("== 8. the device-resident run: ExperimentSpec(), 5 rounds")
    traced_launches, _ = traced_phase(torch)
    by_path["device-resident run (phase 8)"] = traced_launches
    torch.cuda.empty_cache()

    print(f"  phase 8 done at {time.perf_counter() - t_start:.1f} s")
    print("== 9. seed cohorts on the card: lanes of one captured round")
    print("  (a) build_cohort(ExperimentSpec(cohort=8)), 3 rounds")
    cohort_launches, _ = cohort_phase(torch)
    by_path["cohort of 8 (phase 9a)"] = cohort_launches
    torch.cuda.empty_cache()
    print(f"  (a) done at {time.perf_counter() - t_start:.1f} s")
    print("  (b) the stochastic selectors' traced draws, cohorts of 4")
    for selection, n in stochastic_cohort_phase(torch).items():
        by_path[f"{selection} cohort of 4 (phase 9b)"] = n
    torch.cuda.empty_cache()
    print(f"  (b) done at {time.perf_counter() - t_start:.1f} s")
    print("  (c) Fig. 10/11 and Table III, the quick cell")
    fig10_phase(torch)
    torch.cuda.empty_cache()

    print(f"  phase 9 done at {time.perf_counter() - t_start:.1f} s")
    print("== 10. the wireless scenario on the card")
    t10 = time.perf_counter()
    print("  (a) CPU and card agree: a dynamic 2-cell cohort, topk")
    wireless_agreement(torch)
    print("  (b) 3 cells x 2 seeds at full width: one captured round")
    cells_launches, _ = cells_cohort_phase(torch)
    by_path["multicell cohort (phase 10b)"] = cells_launches
    torch.cuda.empty_cache()
    print("  (c) static interference: cell lanes against single runs")
    static_cells_phase(torch)
    print("  (d) topk:0.01 with FedAvgM: traced against the host loop")
    topk_phase(torch)
    print("  (e) rayleigh-block against gauss-markov:0")
    rayleigh_phase(torch)
    torch.cuda.empty_cache()
    print(f"  phase 10 took {time.perf_counter() - t10:.1f} s")

    print(f"  phase 10 done at {time.perf_counter() - t_start:.1f} s")
    print("== 11. the paged client store")
    t11 = time.perf_counter()
    print("  (a) ExperimentSpec(clients=1000) paged against the dense host "
          "loop, 3 rounds")
    by_path["paged store (phase 11a)"], _ = paged_vs_dense_phase(torch)
    torch.cuda.empty_cache()
    print(f"  (a) done at {time.perf_counter() - t_start:.1f} s")
    print("  (b) 4000 clients: waves of 500, minibatch K-means, 3 rounds")
    paged_waves_phase(torch)
    torch.cuda.empty_cache()
    print(f"  (b) done at {time.perf_counter() - t_start:.1f} s")
    print("  (c) population scale: 1e5 and 1e6 clients under churn")
    population_phase(torch)
    torch.cuda.empty_cache()
    print(f"  phase 11 took {time.perf_counter() - t11:.1f} s")

    print(f"  phase 11 done at {time.perf_counter() - t_start:.1f} s")
    print("== 12. the buffered-asynchronous engine")
    t12 = time.perf_counter()
    print("  (a) CPU and card agree: tiny fedbuff:2:0.5 under churn")
    async_agreement(torch)
    print("  (b) fedbuff:10:0 against ExperimentSpec() traced, 5 ticks")
    sync = async_degenerate_phase(torch)
    print(f"  (c) {ASYNC} at full width, {ASYNC_TICKS} ticks")
    single, h_single, by_path["async tick (phase 12c)"], _ = async_tick_phase(
        torch, sync)
    del sync
    torch.cuda.empty_cache()
    print("  (d) the same with cohort=2: one captured tick for both lanes")
    by_path["async cohort of 2 (phase 12d)"] = async_cohort_phase(
        torch, single, h_single)
    del single
    torch.cuda.empty_cache()
    print("  (e) 200 clients: the dense tick against the paged pieces")
    by_path["async paged, 200 clients (phase 12e)"] = async_paged_phase(torch)
    torch.cuda.empty_cache()
    print("  (f) the paged tick at 1e5 and 1e6 clients")
    async_population_phase(torch)
    torch.cuda.empty_cache()
    print(f"  phase 12 took {time.perf_counter() - t12:.1f} s")

    print(f"  phase 12 done at {time.perf_counter() - t_start:.1f} s")
    print("== 13. faults, quarantine and checkpoint/resume")
    t13 = time.perf_counter()
    fault_paths, _ = faults_phase(torch, rows)
    by_path.update(fault_paths)
    print(f"  phase 13 took {time.perf_counter() - t13:.1f} s")

    print(f"  phase 13 done at {time.perf_counter() - t_start:.1f} s")
    print("== 14. the entry points: fl_sim, LoRA-LM lanes, serve, train")
    import tempfile
    t14 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        entry_paths, _ = entry_points_phase(torch, Path(tmp))
    by_path.update(entry_paths)
    print(f"  phase 14 took {time.perf_counter() - t14:.1f} s")

    print(f"  phase 14 done at {time.perf_counter() - t_start:.1f} s")
    print("== 15. the remaining model families: MoE, hybrid, "
          "encoder-decoder, VLM")
    t15 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        family_paths, _ = families_phase(torch, Path(tmp))
    by_path.update(family_paths)
    print(f"  phase 15 took {time.perf_counter() - t15:.1f} s")

    print(f"  phase 15 done at {time.perf_counter() - t_start:.1f} s")
    print("== 16. the kernels")
    replaces = {"flat_aggregate": "src/repro/kernels/flat_aggregate.py:38",
                "pairwise_l2": "src/repro/kernels/pairwise_l2.py:45",
                "flash_attention": "src/repro/kernels/flash_attention.py:70",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:71"}
    kernels = []
    for name, per_shape in rows.items():
        top = per_shape[0]     # the shape its path launches most often
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "shape": top["shape"],
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
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
