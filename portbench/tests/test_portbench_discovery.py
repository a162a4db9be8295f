"""Cells, configurations, traffic, drivers and metrics are found by the
names in BENCHMARK.json, one file each."""
import json

import pytest

import smoke  # noqa: F401
from portbench import harness

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_matches_its_entry(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = harness.load_json("workloads", cell)
    for key in ("config", "traffic", "chips", "why"):
        assert wl[key] == entry[key], key
    harness.load_json("configs", wl["config"])
    harness.load_json("traffic", wl["traffic"])
    assert hasattr(harness.load_module("drivers", wl["entry"]), "setup")


@pytest.mark.parametrize("metric", METRICS)
def test_metric_has_a_reader(metric):
    assert callable(harness.load_module("metrics", metric).read)


@pytest.mark.parametrize("config", BENCH["configs"])
def test_config_file_is_under_paths(config):
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    data = json.loads((harness.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert harness.cell_metrics(BENCH, cell, "per_layer"), cell


def test_metric_selection_follows_workloads_and_moves():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "l1", "moves": "b"},
                           {"name": "l2", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in harness.cell_metrics(bench, "x",
                                                    "end_to_end")] == ["a", "b"]
    assert [m["name"] for m in harness.cell_metrics(bench, "y",
                                                    "end_to_end")] == ["a"]
    assert [m["name"] for m in harness.cell_metrics(bench, "x",
                                                    "per_layer")] == ["l1"]
    assert [m["name"] for m in harness.cell_metrics(bench, "y",
                                                    "per_layer")] == ["l2"]


def test_a_new_cell_is_a_new_file(tmp_path, monkeypatch):
    """A cell, a traffic mix and a metric added as files are found by
    name, with no edit to a file that is there."""
    for kind in ("workloads", "traffic", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "workloads" / "new-cell.json").write_text(
        json.dumps({"name": "new-cell", "traffic": "new-mix"}))
    (tmp_path / "traffic" / "new-mix.json").write_text('{"lanes": 2}')
    (tmp_path / "metrics" / "new.metric.py").write_text(
        "def read(run):\n    return 7.0\n")
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    assert harness.load_json("workloads", "new-cell")["traffic"] == "new-mix"
    assert harness.load_json("traffic", "new-mix") == {"lanes": 2}
    assert harness.load_module("metrics", "new.metric").read(None) == 7.0
