"""Small forms of the benchmark's cells for the CPU tests: the same
drivers, references and checks on the port's plain PyTorch paths, at
sizes a test run holds. ``run(cell, **changes)`` drives a whole run of
the cell but the look for a card."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [p for p in (str(ROOT / "src"), str(ROOT))
                if p not in sys.path]

from portbench import harness  # noqa: E402

CNN_MODEL = dict(conv1_out=10, conv2_out=12, fc1_out=80)   # fashion's CNN
# two clients of each majority class, as the paper's 40 over 10 classes
# has four: K-means then finds clusters a wrong label breaks
CNN_FL = dict(dataset="fashion", clients=20, devices_per_round=10,
              num_clusters=10, local_iters=5, batch_size=8,
              samples_per_client=32, train_samples=400, test_samples=100)
LM = dict(hidden_size=96, num_attention_heads=6, num_key_value_heads=2,
          intermediate_size=280, vocab_size=256, num_hidden_layers=2)
SEED = 2**31 + 12345


def inputs(cell: str):
    """``(workload, config, traffic)`` of ``cell`` at its small size."""
    wl = harness.load_json("workloads", cell)
    cfg = harness.load_json("configs", wl["config"])
    tr = harness.load_json("traffic", wl["traffic"])
    if "model" in cfg:
        cfg["model"].update(CNN_MODEL)
        cfg["fl"].update(CNN_FL)
        tr["rounds_per_call"] = 3
        if "lanes" in tr and tr["lanes"] > 1:
            tr["lanes"], tr["check_lanes"] = 3, 2
    else:
        cfg.update(LM)
    return wl, cfg, tr


def run(cell: str, seconds: float = 0.5, seed: int = SEED):
    wl, cfg, tr = inputs(cell)
    return harness.run_cell(cell, wl, cfg, tr, harness.benchmark(),
                            seed=seed, seconds=seconds, trace=False,
                            device="cpu", log=lambda *a: None)
