"""The two whole-run shares that cells reporting different end-to-end
metrics each read under a name of their own (``metrics/<name>.py``)."""


def idle_share(run):
    """1 − the traced calls' device time a seed-round (the union of their
    device records) over the untraced window's host time a seed-round, in
    %. The profiler slows the host's launches, so the traced calls' own
    host time would count its cost as idle."""
    if run.trace is None or not run.traced_seed_rounds or not run.seed_rounds:
        return None
    busy = run.trace.busy_s() / run.traced_seed_rounds
    return 100.0 * (1.0 - busy / (run.window_s / run.seed_rounds))


def mfu(run):
    """The least time the window's rounds need on the chip (each
    seed-round's operations at the configuration's precision against its
    bytes at 3.35 TB/s, from the model's shapes: ``portbench/cost``) over
    the untraced window's host time, in %."""
    if run.trace is None or not run.seed_rounds:
        return None
    return (100.0 * run.seed_rounds * run.cell.least_seed_round_s
            / run.window_s)
