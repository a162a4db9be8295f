"""build_s: the host clock around the entry's build (``build_experiment``
or ``build_cohort``: data, partition, fleet, the model on the device)."""


def read(run):
    return getattr(run.cell, "build_s", None)
