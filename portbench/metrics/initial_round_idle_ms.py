"""initial_round_idle_ms: the device's idle time a call inside the eager
initial round: the part of each ``fl.initial_round`` host span that no
device record of the traced window (``run.trace.records``) covers. Host
spans and device records share the profiler's clock (Unix-epoch ns)."""
from portbench.program_spans import busy_ns, host_spans


def read(run):
    if run.trace is None:
        return None
    got = host_spans("fl.initial_round")
    if not got:
        return None
    idle = sum((s.end_ns - s.start_ns)
               - busy_ns(run.trace.records, s.start_ns, s.end_ns)
               for s in got)
    return idle / 1e6 / len({s.call for s in got})
