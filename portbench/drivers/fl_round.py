"""Driver of ``repro_torch.launch.fl_round.fl_round_step`` (the paper's
round over whole LM clients): set-up makes the global model, the stacked
clients, the centroids and the sizes from the seed on the device
(``make_s``) and runs ``warm_rounds`` rounds from the global model
(``warm_s``); the window is a closed loop of rounds, each from the last
round's new global model (the first from the seed's), the server reading
the divergences and labels back after each. A round's latency runs from
its call to those on the host.

The check holds the first round a round index drawn from the seed below
``check_sample_below`` and the window's last round to the reference,
each from its own input global model."""
import time

import torch

from portbench import peaks
from portbench.cost import kernels as kernel_cost
from portbench.cost import lm as lm_cost
from portbench.harness import Call, Check, check_rng
from portbench.reference import fl_round as ref
from portbench.traffic import lm_clients


class Cell:
    def __init__(self, ctx):
        from repro_torch.launch.fl_round import fl_round_step
        self.ctx = ctx
        tr, cfg = ctx.traffic, ctx.config
        self.clusters = tr["clusters"]
        self.fl_round_step = fl_round_step
        t0 = time.perf_counter()
        self.g0, self.clients, self.cent, self.sizes = lm_clients(
            cfg, tr, ctx.seed, ctx.device)
        self.sync()
        t1 = time.perf_counter()
        for _ in range(tr["warm_rounds"]):
            out = self.step(self.g0)
            out[1].cpu(), out[2].cpu()
            del out
        self.sync()
        self.make_s, self.warm_s = t1 - t0, time.perf_counter() - t1
        self.sampled = int(check_rng(ctx.seed).integers(
            tr["check_sample_below"]))
        self.g, self.round = self.g0, 0
        del self.g0
        self.kept = {}
        n = tr["clients"]
        flops, nbytes = lm_cost.fl_round(cfg, n, self.clusters)
        self.least_seed_round_s = peaks.least_s(flops, nbytes, "bfloat16")

    def step(self, g):
        return self.fl_round_step(
            self.clients, g, self.cent, self.sizes,
            num_clusters=self.clusters,
            feature_slice=self.ctx.traffic["feature_slice"])

    def sync(self):
        if self.ctx.device == "cuda":
            torch.cuda.synchronize()

    def call(self) -> Call:
        self.last = None          # the round before last's models go
        t0 = time.perf_counter()
        new_g, div, labels = self.step(self.g)
        div, labels = div.cpu(), labels.cpu()
        ms = (time.perf_counter() - t0) * 1e3
        if self.round == 0:       # the fold reads one client a cluster
            self.kernel_calls = lm_cost.round_calls(
                self.ctx.config, self.ctx.traffic["clients"], self.clusters,
                winners=len(set(labels.tolist())))
        if self.round == self.sampled:
            self.kept[self.round] = (self.g, (new_g, div, labels))
        self.last = (self.round, self.g, (new_g, div, labels))
        self.g, self.round = new_g, self.round + 1
        return Call(rounds=1, seed_rounds=1, latencies_ms=[ms])

    def kernel_bound_s(self, kernel: str) -> float:
        """The least time [s] of one round's calls of ``kernel`` on the
        chip, from their shapes."""
        return sum(peaks.least_s(*kernel_cost.cost(c), "bfloat16")
                   for c in self.kernel_calls if c[0] == kernel)

    def release(self):
        self.g = None

    def check(self):
        r, g_in, out = self.last
        self.kept[r] = (g_in, out)
        worst = {}
        for r in sorted(self.kept):
            g_in, got = self.kept[r]
            nums = ref.check_round(self.clients, g_in, self.cent, self.sizes,
                                   self.clusters, got)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
        limits = self.ctx.workload["limits"]
        return [Check(k, v, float(limits[k])) for k, v in worst.items()]


def setup(ctx):
    return Cell(ctx)
