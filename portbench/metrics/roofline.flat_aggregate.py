"""roofline.flat_aggregate: the least time of the traced calls' fold
calls (``portbench/cost/kernels.py`` from their shapes) over the device
time of ``flat_aggregate_kernel``, in %."""


def read(run):
    cell, tr = run.cell, run.trace
    if tr is None or not hasattr(cell, "kernel_bound_s"):
        return None
    spent = tr.time_of(lambda n: "flat_aggregate" in n)
    if spent <= 0.0:
        return None
    bound = run.traced_rounds * cell.kernel_bound_s("flat_aggregate")
    return 100.0 * bound / spent
