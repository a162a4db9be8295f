"""warm_s: the host clock around the first call of the entry in set-up
(the initial round, K-means, the kernels' loading, the round's capture)."""


def read(run):
    return getattr(run.cell, "warm_s", None)
