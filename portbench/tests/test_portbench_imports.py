"""No module of JAX, Flax or the JAX package in a run, by whole
top-level names: the port's name begins with the JAX package's."""
import subprocess
import sys
import types

import smoke
from portbench import harness


def test_top_level_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_x",
                        types.ModuleType("repro_torch_fake_x"))
    for name in ("repro.core", "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert {"repro", "jaxlib", "flax"} <= set(found)
    assert "repro_torch" not in found and "repro_torch_fake_x" not in found


def test_a_run_loads_no_jax(tmp_path):
    """A whole small run of every cell in a fresh process: its modules
    hold none of jax, jaxlib, flax or repro."""
    code = (
        "import smoke\n"
        "from portbench import harness\n"
        "for cell in ('qwen2-round16', 'cnn-sweep8'):\n"
        "    assert smoke.run(cell, seconds=0.2)['correct'], cell\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=smoke.ROOT /
                         "portbench" / "tests", capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
