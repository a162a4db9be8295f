"""A whole small run with the timed path broken underneath comes out not
correct: for each fault a cell can have (``portbench/faults.py``; one
chip: no exchange between chips to leave out)."""
import pytest

import smoke
from portbench import faults, harness

# every cell file, also one BENCHMARK.json leaves out for now
CELLS = sorted(p.stem for p in (harness.BENCH / "workloads").glob("*.json"))
CASES = [(cell, fault) for cell in CELLS
         for fault in faults.FAULTS[harness.load_json("workloads",
                                                      cell)["entry"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    entry = harness.load_json("workloads", cell)["entry"]
    faults.FAULTS[entry][fault](monkeypatch.setattr)
    out = smoke.run(cell, seconds=0.3)
    assert not out["correct"], harness.check_lines(out["checks"])


def test_every_cell_has_the_three_faults():
    for cell in CELLS:
        entry = harness.load_json("workloads", cell)["entry"]
        assert {"state unchanged", "half the batch",
                "an answer altered"} <= set(faults.FAULTS[entry])
