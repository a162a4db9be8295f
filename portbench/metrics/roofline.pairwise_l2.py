"""roofline.pairwise_l2: the least time of the traced calls' distance
calls (``portbench/cost/kernels.py`` from their shapes, bytes at 3.35
TB/s against operations at 989 TFLOP/s) over the device time of the
kernels ``pairwise_l2`` launches (its distance kernels and their slab
sums), in %."""


def read(run):
    cell, tr = run.cell, run.trace
    if tr is None or not hasattr(cell, "kernel_bound_s"):
        return None
    spent = tr.time_of(lambda n: "pairwise_l2" in n or "slab_sum" in n)
    if spent <= 0.0:
        return None
    bound = run.traced_rounds * cell.kernel_bound_s("pairwise_l2")
    return 100.0 * bound / spent
