"""The program's own spans for the readers of ``metrics/`` that read them
(``source: program_span``): what ``repro_torch.utils.spans`` kept during
the traced calls, the torch profiler being its switch. A checkout whose
program has no span module gives none, and each reader then ``None``."""


def recorded() -> list:
    """Every span the program kept (host, device and replay spans)."""
    try:
        from repro_torch.utils import spans
    except ImportError:
        return []
    return spans.recorded()


def replay_ms(name: str):
    """Phase ``name``'s device time [ms] a replayed round: its stamps in
    the replayed graphs, summed, over the replays that hold it (a replay:
    one call's one round of one program, every lane at once)."""
    got = [s for s in recorded() if s.kind == "replay" and s.name == name]
    if not got:
        return None
    replays = {(s.call, s.attrs.get("program"), s.attrs.get("round"))
               for s in got}
    return sum(s.ms for s in got) / len(replays)


def host_spans(name: str) -> list:
    return [s for s in recorded() if s.kind == "host" and s.name == name]


def busy_ns(records, start: int, end: int) -> int:
    """The part of ``[start, end)`` [ns] that the union of the device
    ``records`` (``(start_ns, end_ns, name)``) covers."""
    total, reach = 0, start
    for s, e, _ in sorted(records):
        if s >= end:
            break
        s, e = max(s, reach), min(e, end)
        if e > s:
            total += e - s
            reach = e
    return total
