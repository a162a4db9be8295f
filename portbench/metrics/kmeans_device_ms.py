"""kmeans_device_ms: the K-means assignment's device time a round of
``launch/fl_round.py::fl_round_step`` (``pairwise_l2`` against the
centroids, then the argmin): the stamps around its ``fl.kmeans`` span,
over the traced rounds."""
from portbench.program_spans import recorded


def read(run):
    if run.trace is None or not run.traced_rounds:
        return None
    got = [s for s in recorded()
           if s.kind == "device" and s.name == "fl.kmeans"]
    if not got:
        return None
    return sum(s.ms for s in got) / run.traced_rounds
