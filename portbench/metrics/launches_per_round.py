"""launches_per_round: the device records (kernels, copies, memsets; a
replayed graph gives each of its kernels) of the traced calls between the
marks, over the rounds they replayed (a cohort call's initial rounds
included in its records)."""


def read(run):
    if run.trace is None or not run.traced_rounds:
        return None
    return run.trace.count() / run.traced_rounds
