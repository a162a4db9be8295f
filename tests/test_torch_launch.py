"""The port's entry points (``repro_torch.launch``) against the reference's
(``repro.launch``), on the CPU.

The three parsers take the reference's option strings and defaults, plus
``--device``. ``fl_sim.spec_from_args`` gives the reference's spec on the
same argvs, and the conflict checks raise the reference's ``SystemExit``
text. A tiny ``fl_sim`` run through ``main`` is the port's
``build_experiment(spec, device="cpu").run()`` bit for bit, a resumed run
is the uninterrupted one bit for bit, and the printed JSON keys of the
single-run, cohort and resume branches are the reference's. ``train``
and ``serve`` run with ``--smoke``; the CSV and the checkpoint are
written and load. ``--device cuda`` with no card raises.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import argparse
import contextlib
import io
import json
import shutil
from unittest import mock

import numpy as np
import pytest
import torch

from repro.launch import fl_sim as ref_fl_sim
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train

from repro_torch.api import ExperimentSpec, build_experiment
from repro_torch.configs import get_smoke_config
from repro_torch.launch import fl_sim, serve, train
from repro_torch.models.transformer import init_model
from repro_torch.train.checkpoint import checkpoint_step, load_checkpoint

TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=2, devices_per_round=4, num_clusters=4)
CLIS = {"fl_sim": (ref_fl_sim, fl_sim), "train": (ref_train, train),
        "serve": (ref_serve, serve)}


class _Parsed(Exception):
    pass


def _reference_parser(ref_main):
    """The parser the reference's ``main`` builds (caught at its
    ``parse_args``, before anything runs)."""
    seen = {}

    def capture(self, *args, **kw):
        seen["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        with pytest.raises(_Parsed):
            ref_main([])
    return seen["parser"]


def _options(parser):
    return {a.option_strings[0]: (a.dest, a.default, a.type, a.nargs,
                                  type(a).__name__, a.required)
            for a in parser._actions if a.option_strings[0] != "-h"}


def _write_spec(tmp_path, name="spec.json", **kw):
    path = tmp_path / name
    path.write_text(ExperimentSpec(**dict(TINY, **kw)).to_json())
    return str(path)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _printed_keys(text):
    return set(json.loads(text[:text.index("\n}") + 2]))


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_parsers_take_the_references_options(cli):
    ref_mod, mod = CLIS[cli]
    want = _options(_reference_parser(ref_mod.main))
    got = _options(mod.build_parser())
    assert set(got) - set(want) == {"--device"}
    assert got.pop("--device")[1] == "cuda"
    assert got == want


ARGVS = [
    [],
    ["--dataset", "fashion", "--selection", "divergence", "--allocator",
     "sao", "--rounds", "3"],
    ["--selection", "icas", "--allocator", "fedl:2.0", "--sigma", "H",
     "--cohort", "2", "--seed", "5", "--lr", "0.1", "--target-acc", "0.5"],
    ["--allocator", "sao", "--box-correct", "--per-round", "4",
     "--clients", "12", "--local-iters", "3"],
    ["--async-buffer", "4", "--staleness-alpha", "0.5", "--churn",
     "0.05:0.1", "--store", "paged", "--k-max", "8",
     "--div-refresh-every", "1"],
    ["--faults", "outage:0.1,corrupt:0.05", "--quarantine-after", "2",
     "--aggregator", "trimmed:0.2"],
    ["--cells", "2", "--channel", "multicell-dynamic"],
    ["--channel", "gauss-markov:0.5", "--aggregator", "fedavgm:0.9"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_spec_from_args_matches_the_reference(argv):
    ref_args = _reference_parser(ref_fl_sim.main)
    with mock.patch.object(argparse.ArgumentParser, "parse_args",
                           argparse.ArgumentParser.parse_args):
        ref_spec = ref_fl_sim.spec_from_args(ref_args.parse_args(argv))
    spec = fl_sim.spec_from_args(fl_sim.build_parser().parse_args(argv))
    assert spec.to_dict() == ref_spec.to_dict()


def test_spec_file_and_dump_round_trip(tmp_path):
    path = _write_spec(tmp_path, selection="icas")
    printed = _run(fl_sim.main, ["--spec", path, "--dump-spec"])
    assert ExperimentSpec.from_json(printed) == ExperimentSpec.from_json(
        open(path).read())
    again = tmp_path / "again.json"
    again.write_text(printed)
    assert _run(fl_sim.main, ["--spec", str(again), "--dump-spec"]) == printed


def _conflicts(tmp_path):
    fleet = tmp_path / "fleet.json"
    from repro_torch.api.scenario import multicell_fleet_spec
    fleet.write_text(multicell_fleet_spec(2).to_json())
    return [
        ["--checkpoint-every", "-1"],
        ["--checkpoint-every", "1"],
        ["--resume", str(tmp_path), "--cohort", "2"],
        ["--resume", str(tmp_path), "--checkpoint-dir", "elsewhere"],
        ["--async-buffer", "2", "--aggregator", "fedavg"],
        ["--fleet-spec", str(fleet), "--cells", "2"],
        ["--cohort", "2", "--checkpoint-every", "1", "--checkpoint-dir",
         str(tmp_path)],
    ]


def test_conflict_checks_raise_the_references_text(tmp_path):
    for argv in _conflicts(tmp_path):
        with pytest.raises(SystemExit) as want:
            ref_fl_sim.main(argv)
        with pytest.raises(SystemExit) as got:
            fl_sim.main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value), argv


def test_main_is_the_ports_run_bit_for_bit(tmp_path):
    path, out = _write_spec(tmp_path), tmp_path / "out.jsonl"
    _run(fl_sim.main, ["--spec", path, "--device", "cpu", "--out", str(out)])
    result = json.loads(out.read_text())
    hist = build_experiment(ExperimentSpec(**TINY), device="cpu").run()
    assert result["accuracy"] == hist.accuracy
    assert result["total_T_s"] == hist.total_T
    assert result["total_E_J"] == hist.total_E
    assert result["spec"] == ExperimentSpec(**TINY).to_dict()


def test_resume_is_the_uninterrupted_run(tmp_path):
    """4 rounds with a snapshot a round, the snapshots after round 2
    removed (the run killed there), then ``--resume``: the resumed run's
    history is the uninterrupted one's bit for bit."""
    path, ck = _write_spec(tmp_path, rounds=4), tmp_path / "ck"
    full = tmp_path / "full.jsonl"
    _run(fl_sim.main, ["--spec", path, "--device", "cpu", "--out", str(full),
                       "--checkpoint-every", "1", "--checkpoint-dir",
                       str(ck)])
    for name in ("round_000003", "round_000004"):
        shutil.rmtree(ck / name)
    res = tmp_path / "res.jsonl"
    _run(fl_sim.main, ["--resume", str(ck), "--device", "cpu", "--out",
                       str(res)])
    want, got = json.loads(full.read_text()), json.loads(res.read_text())
    assert got["resumed_from"] == str(ck)
    for key in ("accuracy", "total_T_s", "total_E_J", "spec",
                "clustering_ari"):
        assert got[key] == want[key], key


@pytest.fixture(scope="module")
def reference_single_run(tmp_path_factory):
    """The reference's main on the tiny spec with a snapshot at its last
    round, then resumed from it (no round left to run)."""
    tmp = tmp_path_factory.mktemp("ref")
    path, out, ck = _write_spec(tmp), tmp / "out.jsonl", str(tmp / "ck")
    printed = _run(ref_fl_sim.main, ["--spec", path, "--out", str(out),
                                     "--checkpoint-every", "2",
                                     "--checkpoint-dir", ck])
    return path, printed, json.loads(out.read_text()), _run(
        ref_fl_sim.main, ["--resume", ck])


def test_printed_keys_match_the_reference(reference_single_run, tmp_path):
    """Single run and resume against the reference's main on the same tiny
    spec; the cohort branch against the reference's keys."""
    path, ref_printed, ref_result, ref_resumed = reference_single_run
    out, ck = tmp_path / "out.jsonl", str(tmp_path / "ck")
    printed = _run(fl_sim.main, ["--spec", path, "--device", "cpu", "--out",
                                 str(out), "--checkpoint-every", "2",
                                 "--checkpoint-dir", ck])
    assert _printed_keys(printed) == _printed_keys(ref_printed)
    assert set(json.loads(out.read_text())) == set(ref_result)
    assert printed.splitlines()[-1].startswith("accuracy curve: ")

    resumed = _run(fl_sim.main, ["--resume", ck, "--device", "cpu"])
    assert _printed_keys(resumed) == _printed_keys(ref_resumed)
    assert resumed.splitlines()[-1].startswith("accuracy curve: ")

    cohort = tmp_path / "cohort.json"
    cohort.write_text(ExperimentSpec(**dict(TINY, rounds=1,
                                            cohort=2)).to_json())
    printed = _run(fl_sim.main, ["--spec", str(cohort), "--device", "cpu"])
    assert _printed_keys(printed) == {
        "seeds", "cells", "final_accuracy_mean", "final_accuracy_std",
        "final_accuracy_per_seed", "total_T_s_per_seed",
        "total_E_J_per_seed", "clustering_ari_per_seed"}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_train_writes_its_log_and_checkpoint(tmp_path, arch):
    csv, ck = tmp_path / "log.csv", tmp_path / "ck"
    logger = train.main(["--arch", arch, "--smoke", "--steps", "4",
                         "--batch", "2", "--seq", "16", "--device", "cpu",
                         "--log-csv", str(csv), "--ckpt", str(ck)])
    lines = csv.read_text().splitlines()
    assert lines[0].split(",")[:2] == ["step", "wall_s"]
    assert {"loss", "lr", "gnorm"} <= set(lines[0].split(","))
    assert len(lines) == 1 + 4
    assert all(np.isfinite(logger.history["loss"]))
    assert checkpoint_step(str(ck)) == 4
    template = init_model(get_smoke_config(arch),
                          torch.Generator().manual_seed(0))
    loaded = load_checkpoint(str(ck), template)
    assert set(loaded) == set(template)
    assert all(bool(torch.isfinite(v).all()) for v in loaded.values())


@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
def test_serve_generates(sampler):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tokens = serve.main(["--arch", "mamba2-130m", "--smoke", "--batch",
                             "2", "--gen", "5", "--sampler", sampler,
                             "--device", "cpu"])
    assert tokens.shape == (2, 5)
    assert ((tokens >= 0) & (tokens < 256)).all()
    assert "tok/s" in out.getvalue().splitlines()[0]


@pytest.mark.parametrize("cli,argv", [
    ("fl_sim", ["--rounds", "1"]),
    ("train", ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "1"]),
    ("serve", ["--arch", "mamba2-130m", "--smoke"])])
def test_cuda_without_a_card_raises(cli, argv):
    """``--device cuda`` (the default) never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIS[cli][1].main(argv + ["--device", "cuda"])
