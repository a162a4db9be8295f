"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``,
importing the port's entry point pulls neither in, and the entry point
never falls back to the CPU on its own."""
import torch_threads  # noqa: F401  (first: one torch thread)
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert path.exists()
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.api, repro_torch.core.fedavg, "
            "repro_torch.kernels.ops, repro_torch.models.lm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_build_experiment_raises_without_cuda(monkeypatch):
    from repro_torch.api import ExperimentSpec, build_experiment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ExperimentSpec(dataset="fashion", clients=4, samples_per_client=4,
                          train_samples=40, test_samples=8, local_iters=1,
                          batch_size=2, devices_per_round=2, num_clusters=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_experiment(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_experiment(spec, device="cuda")
    exp = build_experiment(spec, device="cpu")
    assert exp.global_vec.device.type == "cpu"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("field,value", [
    ("aggregator", "trimmed:0.2"), ("aggregator", "clipnorm:1.0"),
    ("aggregator", "clipnorm"),
    ("faults", "outage:0.1"), ("compressor", "qsgd:4"),
    ("p_shards", 2), ("model", "gpt-17")])
def test_spec_rejects_what_the_port_lacks(field, value):
    """A strategy the port lacks raises ``ValueError`` naming the port and
    what it supports, as does a model that is no registered workload. The
    robust aggregators, ``faults`` and ``p_shards``, once refused here,
    are ported: the spec takes them in the reference's JSON form."""
    from repro.api import ExperimentSpec as RefSpec
    from repro_torch.api import ExperimentSpec
    if field in ("aggregator", "faults", "p_shards"):
        spec = ExperimentSpec(**{field: value})
        assert spec.to_dict()[field] == RefSpec(**{field: value}).to_dict()[
            field]
        assert ExperimentSpec.from_json(spec.to_json()) == spec
    elif field == "compressor":
        with pytest.raises(ValueError, match="port"):
            ExperimentSpec(**{field: value})
    else:
        with pytest.raises(ValueError,
                           match="unknown model 'gpt-17'.*mamba2-130m.*"
                                 "tinyllama"):
            ExperimentSpec(**{field: value})


def test_spec_stores_strategies_in_dict_form():
    from repro_torch.api import ExperimentSpec
    spec = ExperimentSpec(selection={"name": "divergence", "params": {}})
    assert spec.selection == {"name": "divergence", "params": {}}
    assert spec.allocator == {"name": "sao",
                              "params": {"box_correct": False}}
    assert spec.aggregator == {"name": "fedavg", "params": {}}


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """No silent fallback: without nvcc the kernels cannot build, and the
    build says where it looked."""
    from repro_torch.kernels import build
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_importing_the_entry_points_loads_no_jax():
    code = ("import sys, repro_torch.core, repro_torch.launch.fl_sim, "
            "repro_torch.launch.train, repro_torch.launch.serve, "
            "repro_torch.serve, repro_torch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _reference_core_names():
    """The names ``src/repro/core/__init__.py`` imports (its public API)."""
    path = ROOT / "src" / "repro" / "core" / "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


def test_public_names_are_the_references():
    """``from repro_torch.api import *`` gives the reference's ``__all__``;
    ``repro_torch.core`` exports the reference's names but those its
    docstring lists as left out."""
    import repro.api
    import repro_torch.api
    import repro_torch.core
    assert sorted(repro_torch.api.__all__) == sorted(repro.api.__all__)
    scope = {}
    exec("from repro_torch.api import *", scope)
    assert set(repro.api.__all__) <= set(scope)
    want = _reference_core_names()
    left_out = want - set(repro_torch.core.__all__)
    assert left_out == {"RoundEngine"}
    assert "RoundEngine" in repro_torch.core.__doc__
    assert set(repro_torch.core.__all__) <= want
    for name in repro_torch.core.__all__:
        assert getattr(repro_torch.core, name) is not None


def test_the_strategies_keep_their_protocols():
    """Every registered strategy satisfies its stage's protocol (a
    stateful channel the whole channel contract)."""
    from repro_torch.api import (AGGREGATORS, ALLOCATORS, CHANNELS,
                                 COMPRESSORS, SELECTORS, Aggregator,
                                 Allocator, ChannelModel, Compressor,
                                 Selector)
    for registry, proto in ((SELECTORS, Selector), (ALLOCATORS, Allocator),
                            (AGGREGATORS, Aggregator),
                            (COMPRESSORS, Compressor)):
        for name in registry.names():
            assert isinstance(registry.resolve(name), proto), name
    for name in CHANNELS.names():
        channel = CHANNELS.resolve(name)
        assert callable(channel.sample_gains), name
        assert callable(channel.apply_traced), name
        if channel.stateful:
            assert isinstance(channel, ChannelModel), name
