"""initial_round_ms: the host's time in a call's eager initial round (the
``fl.initial_round`` span of ``TracedProgram.steps``: every lane's
training, fold and K-means in turn, then evaluation and SAO for all),
over the traced calls."""
from portbench.program_spans import host_spans


def read(run):
    if run.trace is None:
        return None
    got = host_spans("fl.initial_round")
    if not got:
        return None
    return sum(s.ms for s in got) / len({s.call for s in got})
