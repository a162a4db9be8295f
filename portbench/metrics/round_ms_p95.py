"""round_ms_p95: the 95th percentile of the window's round latencies, each
from the round's call to its outputs on the host; nothing where the
cell's rounds end on the device."""
import numpy as np


def read(run):
    if not run.latencies_ms:
        return None
    return float(np.percentile(run.latencies_ms, 95))
