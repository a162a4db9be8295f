"""FL simulation driver — the paper's full framework (Fig. 2) end to end,
declared as an ``ExperimentSpec``, on the card.

  PYTHONPATH=src python -m repro_torch.launch.fl_sim --dataset mnist \
      --selection divergence --rounds 30 --clients 40

  # or fully declaratively:
  PYTHONPATH=src python -m repro_torch.launch.fl_sim --spec my_experiment.json
  PYTHONPATH=src python -m repro_torch.launch.fl_sim --dump-spec  # print + exit

``--device`` (default ``cuda``) names the device the experiment runs on;
``cuda`` with no card raises (``repro_torch.api.build.resolve_device``),
``--device cpu`` runs the plain PyTorch paths.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.api import (ALLOCATORS, CHANNELS, SELECTORS, ExperimentSpec,
                             FleetSpec, build_cohort, build_experiment,
                             multicell_fleet_spec)
from repro_torch.core import adjusted_rand_index


def _ari(exp):
    # Cluster-free drivers (e.g. paged async with a divergence-ranked
    # selector) never fit Alg. 2's K-means; there is no partition to score.
    return (adjusted_rand_index(exp.cluster_labels, exp.fed.majority)
            if exp.cluster_labels is not None else None)


def run_spec(spec: ExperimentSpec, *, device=None, checkpoint_every: int = 0,
             checkpoint_dir: str = None):
    """Build + run one experiment on ``device`` (default ``cuda``);
    returns (exp, history, clustering ARI)."""
    exp = build_experiment(spec, device=device)
    hist = exp.run(rounds=spec.rounds,
                   target_accuracy=spec.target_accuracy or None,
                   checkpoint_every=checkpoint_every,
                   checkpoint_dir=checkpoint_dir,
                   checkpoint_spec=(spec.to_dict() if checkpoint_every
                                    else None))
    return exp, hist, _ari(exp)


def resume_spec(directory: str):
    """The (authoritative) spec a checkpoint directory was taken under,
    plus its completed-round count."""
    from repro_torch.train import checkpoint as ckpt
    path = ckpt.latest_checkpoint(directory)
    extra = ckpt.checkpoint_extra(path)
    if not extra.get("spec"):
        raise SystemExit(
            f"checkpoint {path!r} carries no ExperimentSpec (it was saved "
            "by FLExperiment.save_checkpoint without spec_dict); rebuild "
            "the experiment yourself and call exp.load_checkpoint")
    return ExperimentSpec.from_dict(extra["spec"]), int(extra["round"])


def run_resume(directory: str, *, device=None, rounds: int = 0,
               checkpoint_every: int = 0):
    """Rebuild from a checkpoint's own recorded spec, restore, and run the
    remaining rounds as a bit-identical continuation of the killed run."""
    spec, done = resume_spec(directory)
    total = rounds or spec.rounds
    exp = build_experiment(spec, device=device)
    rnd, hist = exp.load_checkpoint(directory, expected_spec=spec.to_dict())
    remaining = max(total - rnd, 0)
    if remaining:
        hist = exp.run(rounds=remaining, include_initial_round=False,
                       target_accuracy=spec.target_accuracy or None,
                       checkpoint_every=checkpoint_every,
                       checkpoint_dir=directory if checkpoint_every else None,
                       checkpoint_offset=rnd,
                       checkpoint_spec=spec.to_dict(),
                       history=hist)
    return exp, hist, _ari(exp)


def run_cohort_spec(spec: ExperimentSpec, *, device=None):
    """Run seeds ``seed..seed+cohort-1`` as lanes of ONE captured round.

    Returns (runner, CohortHistory); per-seed ``FLHistory`` views come from
    ``cohort_hist.history(i)``.
    """
    runner = build_cohort(spec, device=device)
    return runner, runner.run()


def _allocator_ref(allocator: str, box_correct: bool):
    """Fold the legacy --box-correct flag into the sao allocator params."""
    if box_correct and allocator.partition(":")[0] == "sao":
        return {"name": "sao", "params": {"box_correct": True}}
    return allocator


def run(dataset: str, selection: str, *, rounds: int, clients: int,
        per_round: int, sigma, local_iters: int, allocator: str = "sao",
        box_correct: bool = False, seed: int = 0, samples_per_client: int = 128,
        train_samples: int = 4000, test_samples: int = 1000,
        target_accuracy: float = 0.0, lr: float = 0.05, device=None):
    """Back-compat kwargs shim over :func:`run_spec`."""
    alloc = _allocator_ref(allocator, box_correct)
    spec = ExperimentSpec(dataset=dataset, selection=selection,
                          rounds=rounds, clients=clients,
                          devices_per_round=per_round, sigma=sigma,
                          local_iters=local_iters, allocator=alloc,
                          seed=seed, samples_per_client=samples_per_client,
                          train_samples=train_samples,
                          test_samples=test_samples,
                          target_accuracy=target_accuracy,
                          learning_rate=lr)
    return run_spec(spec, device=device)


def _fleet_from_args(args):
    """--fleet-spec file (+--channel override) or --cells/--channel
    shorthand; None (legacy sample_fleet) when neither is given."""
    if getattr(args, "fleet_spec", None):
        if getattr(args, "cells", 0):
            raise SystemExit("--cells conflicts with --fleet-spec (the "
                             "file defines the cells); edit the spec or "
                             "drop one flag")
        with open(args.fleet_spec) as f:
            fs = FleetSpec.from_json(f.read())
        if getattr(args, "channel", None):
            fs = fs.replace(channel=args.channel)
        return fs
    cells = getattr(args, "cells", 0) or 0
    channel = getattr(args, "channel", None)
    if cells <= 0 and channel is None:
        return None
    return multicell_fleet_spec(max(cells, 1),
                                **({"channel": channel} if channel else {}))


def spec_from_args(args) -> ExperimentSpec:
    if args.spec:
        with open(args.spec) as f:
            return ExperimentSpec.from_json(f.read())
    sigma = args.sigma if args.sigma == "H" else float(args.sigma)
    extra = {}
    if getattr(args, "aggregator", None):
        extra["aggregator"] = args.aggregator
    if getattr(args, "async_buffer", 0):
        if extra.get("aggregator"):
            raise SystemExit("--async-buffer selects the fedbuff aggregator "
                             "itself; it conflicts with --aggregator")
        # --async-buffer M routes the run onto the buffered-asynchronous
        # tick engine via the fedbuff:M[:alpha] aggregator
        extra["aggregator"] = (
            f"fedbuff:{args.async_buffer}:{args.staleness_alpha}")
    if getattr(args, "churn", None):
        from repro_torch.core.async_engine import parse_churn
        leave, join = parse_churn(args.churn)
        extra["churn_leave"], extra["churn_join"] = leave, join
    if getattr(args, "store", "dense") != "dense":
        extra["store"] = args.store
    if getattr(args, "k_max", 0):
        extra["k_max"] = args.k_max
    if getattr(args, "div_refresh_every", 0):
        extra["div_refresh_every"] = args.div_refresh_every
    if getattr(args, "faults", None):
        extra["faults"] = args.faults
    if getattr(args, "quarantine_after", 0):
        extra["quarantine_after"] = args.quarantine_after
    return ExperimentSpec(dataset=args.dataset, selection=args.selection,
                          allocator=_allocator_ref(args.allocator,
                                                   args.box_correct),
                          rounds=args.rounds,
                          clients=args.clients,
                          devices_per_round=args.per_round, sigma=sigma,
                          local_iters=args.local_iters,
                          learning_rate=args.lr,
                          target_accuracy=args.target_acc, seed=args.seed,
                          cohort=args.cohort,
                          fleet=_fleet_from_args(args), **extra)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", default=None,
                    help="ExperimentSpec JSON file (overrides other flags)")
    ap.add_argument("--dataset", choices=["mnist", "cifar10", "fashion"],
                    default="mnist")
    ap.add_argument("--selection", default="divergence",
                    help=f"one of {SELECTORS.names()} (':arg' allowed)")
    ap.add_argument("--allocator", default="sao",
                    help=f"one of {ALLOCATORS.names()} (e.g. 'fedl:2.0')")
    ap.add_argument("--aggregator", default=None,
                    help="aggregation strategy (':arg' allowed), e.g. "
                         "'fedavgm:0.9', or the robust folds 'trimmed:0.1' "
                         "/ 'clipnorm:1.0'; default fedavg")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--per-round", type=int, default=10)
    ap.add_argument("--sigma", default="0.8")
    ap.add_argument("--local-iters", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--target-acc", type=float, default=0.0)
    ap.add_argument("--box-correct", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cohort", type=int, default=1,
                    help="run seeds seed..seed+N-1 as lanes of one "
                         "captured round (traceable strategies only)")
    ap.add_argument("--fleet-spec", default=None,
                    help="FleetSpec JSON file: declarative multi-cell "
                         "topology + channel model "
                         "(repro_torch.api.scenario)")
    ap.add_argument("--cells", type=int, default=0,
                    help="shorthand: N default cells on the auto layout "
                         "(N>1 implies the multicell-interference channel; "
                         "add --channel multicell-dynamic for selection-"
                         "driven per-round interference); runs (seeds × "
                         "cells) lanes on the cohort engine")
    ap.add_argument("--channel", default=None,
                    help=f"channel model override, one of {CHANNELS.names()} "
                         "(':arg' allowed, e.g. 'rayleigh-block:0.01')")
    ap.add_argument("--async-buffer", type=int, default=0, metavar="M",
                    help="buffered-asynchronous engine: fire the "
                         "aggregation buffer every M landed updates "
                         "(fedbuff:M aggregator); 0 = synchronous barrier")
    ap.add_argument("--staleness-alpha", type=float, default=0.0,
                    help="staleness discount exponent for --async-buffer: "
                         "fired weights scale by (1+age)^-alpha")
    ap.add_argument("--churn", default=None, metavar="P_LEAVE[:P_JOIN]",
                    help="per-tick Bernoulli client churn probabilities "
                         "(needs --async-buffer), e.g. '0.05:0.1'")
    ap.add_argument("--store", choices=["dense", "paged"], default="dense",
                    help="client-state backend: 'dense' keeps the [N, P] "
                         "plane on device; 'paged' pages cold rows to host "
                         "(O(k_max*P) device memory; composes with "
                         "--async-buffer and --churn)")
    ap.add_argument("--k-max", type=int, default=0,
                    help="paged store: active-plane rows kept on device "
                         "(0 = auto: max(per-round, 256) capped at N)")
    ap.add_argument("--div-refresh-every", type=int, default=0,
                    help="paged store: refresh exact divergences every R "
                         "selections/ticks (1 = exact dense signal every "
                         "time; 0 = lazy drift-bounded staleness)")
    ap.add_argument("--faults", default=None, metavar="KIND:RATE[,...]",
                    help="fault-injection spec, e.g. 'outage:0.1,"
                         "corrupt:0.05' — kinds: outage, chan_outage "
                         "(needs a stateful --channel, e.g. gauss-markov), "
                         "corrupt, byzantine[+byz_scale:S], deadline:T_s; "
                         "rates in [0,1]")
    ap.add_argument("--quarantine-after", type=int, default=0, metavar="K",
                    help="quarantine a client after K non-finite uploads "
                         "(0 = never); pairs with robust aggregators "
                         "--aggregator trimmed:f / clipnorm:c")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                    help="snapshot the full run state (global row, opt "
                         "state, stats, RNG, store rows) every K rounds "
                         "(atomic; needs --checkpoint-dir)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for round_* snapshots + LATEST pointer")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume from the latest complete snapshot under "
                         "DIR; the checkpoint's own recorded spec is "
                         "authoritative (other experiment flags ignored). "
                         "Continuation is bit-identical to the unkilled run")
    ap.add_argument("--dump-spec", action="store_true",
                    help="print the resolved ExperimentSpec JSON and exit")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device to run on: 'cuda' (the card; raises when "
                         "there is none) or 'cpu' (the plain PyTorch paths)")
    return ap


def run_result(spec: ExperimentSpec, hist, ari, **extra) -> dict:
    """The record of one run (or one resumed run: ``extra`` gives
    ``resumed_from``), as ``--out`` appends it."""
    return {"spec": spec.to_dict(), **extra,
            "final_accuracy": hist.accuracy[-1],
            "accuracy": hist.accuracy,
            "total_T_s": hist.total_T, "total_E_J": hist.total_E,
            "rounds_to_target": hist.rounds_to_target,
            "clustering_ari": ari}


def format_result(result: dict) -> str:
    """What ``main`` prints for one run: the record less its accuracy curve
    and spec, as JSON, then the curve rounded."""
    return (json.dumps({k: v for k, v in result.items()
                        if k not in ("accuracy", "spec")}, indent=1)
            + "\naccuracy curve: "
            + str(np.round(result["accuracy"], 3).tolist()))


def _write_out(path, result):
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(result) + "\n")


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.checkpoint_every < 0:
        raise SystemExit("--checkpoint-every must be >= 0")
    if args.checkpoint_every and not (args.checkpoint_dir or args.resume):
        raise SystemExit("--checkpoint-every needs --checkpoint-dir "
                         "(or --resume, which keeps snapshotting in place)")

    if args.resume:
        if args.spec or args.cohort > 1 or args.cells:
            raise SystemExit("--resume restores the checkpoint's own spec; "
                             "it conflicts with --spec/--cohort/--cells")
        if args.checkpoint_dir and args.checkpoint_dir != args.resume:
            raise SystemExit("--resume continues snapshotting into the "
                             "resumed directory; drop --checkpoint-dir")
        exp, hist, ari = run_resume(args.resume, device=args.device,
                                    checkpoint_every=args.checkpoint_every)
        result = run_result(exp.spec, hist, ari, resumed_from=args.resume)
        print(format_result(result))
        _write_out(args.out, result)
        return

    spec = spec_from_args(args)
    if args.dump_spec:
        print(spec.to_json(indent=1))
        return

    if spec.cohort > 1 or spec.num_cells > 1:
        if args.checkpoint_every:
            raise SystemExit("--checkpoint-every is a single-lane feature; "
                             "the vmapped cohort program has no host "
                             "boundary to snapshot at (drop --cohort/"
                             "--cells or the checkpoint flags)")
        if spec.target_accuracy:
            print(f"warning: --cohort runs all {spec.rounds} rounds as one "
                  "compiled program; target_accuracy early stopping is "
                  "ignored (compute rounds-to-target from the curves)",
                  file=sys.stderr)
        runner, ch = run_cohort_spec(spec, device=args.device)
        aris = [adjusted_rand_index(e.cluster_labels, e.fed.majority)
                for e in runner.experiments]
        result = {
            "spec": spec.to_dict(),
            "seeds": ch.seeds,
            "cells": ch.lane_cells,
            "final_accuracy_mean": float(np.mean(ch.final_accuracy)),
            "final_accuracy_std": float(np.std(ch.final_accuracy)),
            "final_accuracy_per_seed": ch.final_accuracy.tolist(),
            "total_T_s_per_seed": np.sum(ch.T_k, axis=1).tolist(),
            "total_E_J_per_seed": np.sum(ch.E_k, axis=1).tolist(),
            "clustering_ari_per_seed": aris,
        }
        print(json.dumps({k: v for k, v in result.items() if k != "spec"},
                         indent=1))
        _write_out(args.out, result)
        return

    exp, hist, ari = run_spec(spec, device=args.device,
                              checkpoint_every=args.checkpoint_every,
                              checkpoint_dir=args.checkpoint_dir)
    result = run_result(spec, hist, ari)
    print(format_result(result))
    _write_out(args.out, result)


if __name__ == "__main__":
    main()
