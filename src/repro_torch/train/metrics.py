"""Minimal metrics logging: in-memory history + CSV flush."""
from __future__ import annotations

import csv
import os
import time
from collections import defaultdict
from typing import Dict


class MetricsLogger:
    def __init__(self, csv_path: str = None):
        self.history = defaultdict(list)
        self.csv_path = csv_path
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict):
        """Record ``metrics`` (numbers or 0-d tensors: each read back to
        the host here) at ``step``."""
        self.history["step"].append(step)
        self.history["wall_s"].append(time.time() - self._t0)
        for k, v in metrics.items():
            self.history[k].append(float(v))

    def flush(self):
        if not self.csv_path:
            return
        os.makedirs(os.path.dirname(self.csv_path) or ".", exist_ok=True)
        keys = list(self.history.keys())
        rows = zip(*[self.history[k] for k in keys])
        with open(self.csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(keys)
            w.writerows(rows)

    def last(self, key: str):
        return self.history[key][-1] if self.history[key] else None
