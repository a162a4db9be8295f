"""Each cell's control, put in the program's place, comes out not
correct: the LM round on fp8 clients (here at the small size on the CPU,
and at the cell's own size on the card), the CNN cell's local-SGD rows
from the reference in TF32 (the card only: the CPU has no TF32). Run on
the card with ``python -m pytest -m cuda portbench/tests``."""
import gc

import pytest
import torch

import smoke
from portbench import harness, readings


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the cells' own sizes")
    yield
    gc.collect()                   # the next case's 66 GB need the card
    torch.cuda.empty_cache()


def _run_cell(cell, seed, seconds, device):
    wl = harness.load_json("workloads", cell)
    cfg = harness.load_json("configs", wl["config"])
    tr = harness.load_json("traffic", wl["traffic"])
    return harness.run_cell(cell, wl, cfg, tr, harness.benchmark(),
                            seed=seed, seconds=seconds, trace=False,
                            device=device, log=lambda *a: None)


def test_fp8_round_is_not_correct_on_the_cpu(monkeypatch):
    from repro_torch.launch import fl_round
    monkeypatch.setattr(fl_round, "fl_round_step", fl_round.fl_round_step)
    readings.fp8_round()
    out = smoke.run("qwen2-round16", seconds=0.2)
    checks = {c.name: c for c in out["checks"]}
    assert not out["correct"]
    assert not checks["div_gap"].ok


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_tf32_rows_are_not_correct(card, seed, monkeypatch):
    from portbench import flcnn
    monkeypatch.setitem(flcnn.CONTROL, "rows", None)
    readings.tf32_rows()
    out = _run_cell("cnn-sweep8", seed, 1.0, "cuda")
    checks = {c.name: c for c in out["checks"]}
    assert not out["correct"] and not checks["sgd_gap"].ok


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_fp8_round_is_not_correct_at_the_cells_size(card, seed,
                                                     monkeypatch):
    from repro_torch.launch import fl_round
    monkeypatch.setattr(fl_round, "fl_round_step", fl_round.fl_round_step)
    readings.fp8_round()
    out = _run_cell("qwen2-round16", seed, 0.5, "cuda")
    assert not out["correct"], harness.check_lines(out["checks"])
