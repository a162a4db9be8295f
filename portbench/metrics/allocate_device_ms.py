"""allocate_device_ms: the allocation phase's device time a replayed
round, every lane at once: the stamps around ``fl.allocate`` (SAO's solve
inside the captured round, the one the rate pays for), read from the
traced calls' replays. ``sao_solve_ms`` times the solve alone, outside the
round."""
from portbench.program_spans import replay_ms


def read(run):
    if run.trace is None:
        return None
    return replay_ms("fl.allocate")
