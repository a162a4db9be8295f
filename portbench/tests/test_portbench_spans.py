"""The readers of the program's spans (``source: program_span``) on
synthetic runs: the spans a profiled call would keep, the device records
of its trace; each reader gives ``None`` without spans, without a trace,
and where the program has no span module."""
import builtins
from types import SimpleNamespace

import pytest

import smoke  # noqa: F401
from portbench import harness, program_spans
from repro_torch.utils.spans import Span

MS = 1_000_000


def _span(name, kind, start_ms, end_ms, call, **attrs):
    return Span(name, kind, int(start_ms * MS), int(end_ms * MS), 0, None,
                call, attrs)


SPANS = [
    _span("fl.call", "host", 0, 100, 1),
    _span("fl.initial_round", "host", 10, 30, 1, program=0),
    _span("fl.kmeans", "device", 500, 503, 1),
    _span("fl.train", "replay", 900, 904, 1, program=0, round=1),
    _span("fl.allocate", "replay", 904, 905, 1, program=0, round=1),
    _span("fl.train", "replay", 910, 916, 1, program=0, round=2),
    _span("fl.allocate", "replay", 916, 918, 1, program=0, round=2),
    _span("fl.call", "host", 200, 300, 2),
    _span("fl.initial_round", "host", 210, 250, 2, program=0),
    _span("fl.kmeans", "device", 600, 601, 2),
    _span("fl.train", "replay", 920, 922, 2, program=0, round=1),
]
# device records [ns]: 5 ms of work inside the first initial round (two
# overlapping records), 30 inside the second, one outside both
RECORDS = [(12 * MS, 15 * MS, "a"), (14 * MS, 17 * MS, "b"),
           (215 * MS, 245 * MS, "c"), (60 * MS, 70 * MS, "d")]


def _run(traced_rounds=4, trace=True):
    tr = harness.Trace(RECORDS, 1, 1, 1.0) if trace else None
    return SimpleNamespace(trace=tr, traced_rounds=traced_rounds)


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


@pytest.fixture
def kept(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: list(SPANS))


@pytest.mark.parametrize("name,want", [
    ("train_device_ms", (4 + 6 + 2) / 3),     # 3 replays, each with train
    ("allocate_device_ms", (1 + 2) / 2),      # 2 replays with allocate
    ("initial_round_ms", (20 + 40) / 2),      # 2 calls
    ("initial_round_idle_ms", ((20 - 5) + (40 - 30)) / 2),
    ("kmeans_device_ms", (3 + 1) / 4),        # 4 traced rounds
])
def test_span_readers(kept, name, want):
    assert _read(name, _run()) == pytest.approx(want)
    assert _read(name, _run(trace=False)) is None


@pytest.mark.parametrize("name", ["train_device_ms", "allocate_device_ms",
                                  "initial_round_ms", "initial_round_idle_ms",
                                  "kmeans_device_ms"])
def test_span_readers_without_spans(monkeypatch, name):
    monkeypatch.setattr(program_spans, "recorded", lambda: [])
    assert _read(name, _run()) is None


def test_no_span_module_reads_nothing(monkeypatch):
    real = builtins.__import__

    def no_spans(name, *args, **kwargs):
        if name.startswith("repro_torch.utils") and (
                "spans" in name or "spans" in (args[2] or ())):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    assert program_spans.recorded() == []
    assert _read("train_device_ms", _run()) is None


def test_busy_ns_clips_to_the_span():
    recs = [(0, 10, "a"), (5, 20, "b"), (30, 40, "c")]
    assert program_spans.busy_ns(recs, 8, 35) == (20 - 8) + (35 - 30)
    assert program_spans.busy_ns(recs, 20, 30) == 0
    assert program_spans.busy_ns([], 0, 10) == 0
