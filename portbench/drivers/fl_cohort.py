"""Driver of ``CohortRunner.run`` (a seed sweep: seeds seed .. seed + B − 1
as lanes of one captured round): set-up builds the runner with the
benchmark's draws, one a lane (``build_s``), and runs ``warm_calls``
calls: the lanes' experiments, their initial rounds, K-means, the
capture of the round and, in the second, the capture of the initial
round's solve over all devices (``warm_s``); a timed call is ``run(rounds=R, reuse_experiments=True)``:
every lane's initial round again (eager, lane by lane), then R replays.
Only the replayed rounds count, times the lanes; the initial rounds'
time stays in the window.

The check (``flcnn.check_call``) holds every call of the window and
every lane to the reference: each lane's initial round from the
program's row at the call's start, K-means, and its rounds; SAO's
answers of ``check_lanes`` lanes of one call drawn from the seed."""
import time

import numpy as np
import torch

from portbench import flcnn
from portbench.harness import Call, check_rng
from portbench.traffic import SeedDraws


class Cell:
    def __init__(self, ctx):
        from repro_torch.api import build_cohort
        self.ctx = ctx
        self.R = ctx.traffic["rounds_per_call"]
        self.B = ctx.traffic["lanes"]
        self.draws = {}

        def draws(seed):
            self.draws[seed] = SeedDraws(seed, ctx.device,
                                         ctx.config["model"])
            return self.draws[seed]

        spec = flcnn.spec_of(ctx.config, ctx.traffic,
                             ctx.seed).replace(cohort=self.B)
        self.seeds = [ctx.seed + i for i in range(self.B)]
        t0 = time.perf_counter()
        self.runner = build_cohort(spec, device=ctx.device, draws=draws)
        self.sync()
        t1 = time.perf_counter()
        for _ in range(ctx.traffic["warm_calls"]):
            self.runner.run(rounds=self.R, reuse_experiments=True)
        self.sync()
        self.build_s, self.warm_s = t1 - t0, time.perf_counter() - t1
        self.calls = []
        self.least_seed_round_s = flcnn.least_seed_round_s(ctx.config)

    def sync(self):
        if self.ctx.device == "cuda":
            torch.cuda.synchronize()

    def state(self):
        return [(e.global_vec, e.client_plane, len(self.draws[s].batches))
                for e, s in zip(self.runner.experiments, self.seeds)]

    def call(self) -> Call:
        start = self.state()
        hist = self.runner.run(rounds=self.R, reuse_experiments=True)
        labels = [np.array(e.cluster_labels) for e in self.runner.experiments]
        self.calls.append((start, hist, labels))
        return Call(rounds=self.R, seed_rounds=self.R * self.B)

    def measure_layers(self):
        """``sao_solve_ms``: the solve alone at the last round's selected
        devices' arrays, the lanes stacked."""
        from repro_torch.core.wireless import fleet_arrays
        hist = self.calls[-1][1]
        sel, mask = hist.selected[:, -1], hist.mask[:, -1]
        fleets = [e.fleet.select(np.where(m, s, 0))
                  for e, s, m in zip(self.runner.experiments, sel, mask)]
        arr = fleet_arrays(fleets, self.ctx.device)
        self.sao_solve_ms = flcnn.time_solve(
            arr, self.ctx.config["fl"]["bandwidth_mhz"],
            torch.as_tensor(mask, device=self.ctx.device))

    def release(self):
        self.runner.program = None
        self.runner.programs = []

    def check(self):
        flcnn.tf32_off()
        cfg, dev, seed = self.ctx.config, self.ctx.device, self.ctx.seed
        gaps = flcnn.Gaps()
        rng = check_rng(seed)
        k = int(rng.integers(len(self.calls)))
        sampled = set(rng.choice(self.B, self.ctx.traffic["check_lanes"],
                                 replace=False).tolist())
        lanes = [flcnn.reference_lane(cfg, s, dev) for s in self.seeds]
        for c, (start, hist, labels) in enumerate(self.calls):
            end = (self.calls[c + 1][0] if c + 1 < len(self.calls)
                   else self.state())
            for i, lane in enumerate(lanes):
                g0, _, pos = start[i]
                g_end, plane_end, _ = end[i]
                batches = self.draws[self.seeds[i]].batches
                init = (batches[pos], (hist.accuracy[i, 0], hist.T_k[i, 0],
                                       hist.E_k[i, 0]))
                rounds = [(hist.selected[i, j][hist.mask[i, j]],
                           hist.accuracy[i, j + 1], hist.T_k[i, j + 1],
                           hist.E_k[i, j + 1]) for j in range(self.R)]
                flcnn.check_call(lane, gaps, labels[i], g0, init, rounds,
                                 batches[pos + 1:pos + 1 + self.R], g_end,
                                 plane_end, allocate=c == k and i in sampled)
        self.ctx.log(f"portbench: {gaps.rows()} client rows compared "
                     f"after local SGD from a known start (lane, stage, "
                     f"rows, worst gap to the update, to the row): "
                     f"{gaps.lane_worst()}")
        return gaps.checks(self.ctx.workload["limits"])


def setup(ctx):
    return Cell(ctx)
