"""The dry run (``repro_torch.launch.dryrun``), after the reference's
``tests/test_dryrun_cli.py``:

(a) the CLI in a subprocess: one (arch × shape × mesh) on the production
    mesh finishes in under 30 s; its record has every key the reference's
    records have (read from the reference module's source, which is not
    imported: importing it forces 512 host devices on JAX), ``chips ==
    256``, the reference's ``model_flops``, ``null`` where the port has no
    counterpart, and a per-device footprint under the H100's 80 GB;
(b) ``run_one`` on both meshes: the counted FLOPs at least
    ``model_flops``, the count shared by the meshes (global FLOPs equal),
    the footprint split by the rules, and every struct on ``meta``;
(c) the twin chunking counts the blocked cross-attention's FLOPs;
every record: its collective bytes ``null`` only where
``collectives_reason`` says why, and its tracked peak at least the
arguments and results under the rules (``peak_memory_lower_bound``);
(d) ``main`` collects a combination that fails and goes on, as the
    reference's does, and exits 1.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import INPUT_SHAPES as REF_INPUT_SHAPES
from repro.roofline.analysis import RooflineReport as RefReport
from repro.roofline.analysis import model_flops as ref_model_flops

from repro_torch.launch import dryrun

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _reference_keys():
    """The keys of a reference record: its report's ``to_dict`` and every
    ``d["…"] =`` its ``run_one`` adds."""
    src = open(os.path.join(ROOT, "src", "repro", "launch",
                            "dryrun.py")).read()
    report = RefReport(arch="x", shape="y", mesh="single", chips=1,
                       flops_per_device=1.0, bytes_per_device=1.0,
                       collective_bytes_per_device=1.0, model_flops_global=1)
    return set(report.to_dict()) | set(re.findall(r'd\["(\w+)"\] =', src))


NULL = ("compile_s", "twin_compile_s", "twin_layers")


def _filled(rec):
    """The collectives ``null`` only with the reason, positive where the
    mesh shards; the tracked peak at least the old lower bound."""
    if rec["collectives_reason"] is not None:
        assert rec["collective_bytes_per_device"] is None
        assert rec["collectives"] is None and rec["collective_s"] is None
    else:
        assert rec["collective_bytes_per_device"] == rec["collectives"][
            "total"] > 0
        assert rec["collective_s"] > 0
    assert rec["peak_memory_per_device"] >= rec["peak_memory_lower_bound"]


def test_the_cli_on_one_combination(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "tinyllama-1.1b", "--shape", "decode_32k",
         "--mesh", "single", "--no-twin", "--out", str(out)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    took = time.perf_counter() - t0
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert took < 30.0, took
    rec = json.loads(out.read_text().splitlines()[0])
    keys = _reference_keys()
    assert {"twin_layers", "lower_s", "bottleneck"} <= keys
    assert keys <= set(rec)
    assert rec["arch"] == "tinyllama-1.1b" and rec["chips"] == 256
    assert rec["model_flops_global"] == ref_model_flops(
        ref_get_config("tinyllama-1.1b"), REF_INPUT_SHAPES["decode_32k"],
        include_backward=False)
    assert rec["peak_memory_lower_bound"] < 80e9
    assert all(rec[k] is None for k in NULL)
    _filled(rec)
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert "all dry-runs OK" in res.stdout


@pytest.mark.parametrize("arch,shape", [
    ("tinyllama-1.1b", "long_500k"), ("mamba2-130m", "decode_32k"),
    ("granite-moe-3b-a800m", "long_500k"), ("phi-3-vision-4.2b",
                                            "decode_32k")])
def test_run_one_on_both_meshes(arch, shape):
    recs = [dryrun.run_one(arch, shape, mesh, verbose=False)
            for mesh in ("single", "multi")]
    for rec, chips in zip(recs, (256, 512)):
        assert rec["chips"] == chips
        flops = rec["flops_per_device"] * chips
        assert flops >= rec["model_flops_global"] > 0
        assert all(rec[k] is None for k in NULL)
        _filled(rec)
        assert rec["useful_ratio"] == pytest.approx(
            rec["model_flops_global"] / flops)
    assert (recs[0]["flops_per_device"] * 256
            == recs[1]["flops_per_device"] * 512)
    assert recs[1]["peak_memory_lower_bound"] <= recs[0][
        "peak_memory_lower_bound"]


def test_the_lowered_step_lies_on_meta():
    cfg = dryrun.get_config("tinyllama-1.1b")
    shape = dryrun.get_input_shape("decode_32k")
    lo = dryrun.lower_decode(cfg, shape, dryrun.make_production_mesh(),
                             moe_impl="dense")
    logits, cache = lo.count().outputs
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (128, 1, cfg.vocab_size)
    assert all(t.device.type == "meta" for t in cache.values())
    assert lo.donate == (2,)


def test_the_twin_counts_the_blocked_cross_attention():
    """seamless's train step counted at the twin's unblocked chunks and,
    under ``twin=False``, at 2 × 2 blocks of its cross-attention: the same
    products."""
    kw = dict(verbose=False)
    twin = dryrun.run_one("seamless-m4t-medium", "train_4k", "single", **kw)
    blocked = dryrun.run_one("seamless-m4t-medium", "train_4k", "single",
                             twin=False, q_chunk=2048, kv_chunk=2048, **kw)
    assert twin["flops_per_device"] == blocked["flops_per_device"]
    assert twin["peak_memory_lower_bound"] == blocked[
        "peak_memory_lower_bound"]
    for rec in (twin, blocked):
        _filled(rec)


def test_main_collects_failures(capsys, monkeypatch):
    """A combination that raises is listed and the others still run, as
    in the reference's ``main``, which then exits 1; the dispatch MoE
    runs on ``meta`` like the dense one."""
    run_one = dryrun.run_one

    def failing_on_single(arch, shape, mesh, **kw):
        if mesh == "single":
            raise RuntimeError("no such mesh")
        return run_one(arch, shape, mesh, **kw)

    monkeypatch.setattr(dryrun, "run_one", failing_on_single)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "granite-moe-3b-a800m", "--shape",
                     "long_500k", "--mesh", "both", "--moe-impl",
                     "dispatch"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAILED 1:" in out
    assert "granite-moe-3b-a800m × long_500k × single -> no such mesh" in out
    assert '"chips": 512' in out and '"moe_impl": "dispatch"' in out
