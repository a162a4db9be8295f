"""The port's spans (``repro_torch.utils.spans``) and device stamps
(``repro_torch.kernels.stamp``): kept only while a torch profiler records,
nested by call, on the profiler's clock; a cohort's and ``fl_round_step``'s
spans; the stamp ring's decoding. The cases marked ``cuda`` need the card
(the stamp kernel has no CPU mode) and skip here; on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spans.py
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import ExperimentSpec, build_cohort
from repro_torch.kernels.stamp import decode
from repro_torch.launch.fl_round import fl_round_step
from repro_torch.utils import spans
from repro_torch.utils.spans import span

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=2, devices_per_round=4, num_clusters=4, cohort=2)


@pytest.fixture(autouse=True)
def fresh():
    spans.clear()
    yield
    spans.clear()


def _names(got, kind="host"):
    return [s.name for s in got if s.kind == kind]


def test_nothing_is_kept_without_a_profiler():
    with span("fl.call", lanes=2):
        with span("fl.train", torch.device("cpu")):
            torch.ones(3).sum()
    assert spans.recorded() == []
    assert not spans.recording()


def test_names_start_with_fl():
    with pytest.raises(ValueError, match="start with 'fl.'"):
        span("train")


def test_spans_nest_under_their_call_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.recording()
        with span("fl.call", lanes=1):
            with span("fl.stack"):
                pass
            with span("fl.replay", round=1):
                with span("fl.train", "cpu"):
                    time.sleep(0.002)
        with span("fl.call"):
            pass
    got = {s.name + str(s.attrs.get("round", "")): s
           for s in spans.recorded()}
    assert len(spans.recorded()) == 5
    first, second = [s for s in spans.recorded() if s.name == "fl.call"]
    assert first.parent is None and first.call == first.id
    assert second.call == second.id != first.id
    assert got["fl.stack"].parent == first.id
    assert got["fl.replay1"].parent == first.id
    assert got["fl.train"].parent == got["fl.replay1"].id
    for s in (got["fl.stack"], got["fl.replay1"], got["fl.train"]):
        assert s.call == first.id and s.kind == "host"
        assert first.start_ns <= s.start_ns <= s.end_ns <= first.end_ns
    assert got["fl.train"].ms >= 2.0
    # the profiler's own fl.* CPU events, on the same clock
    kineto = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("fl."):
            kineto.setdefault(e.name(), []).append(e.start_ns())
    ours = {}
    for s in spans.recorded():
        ours.setdefault(s.name, []).append(s.start_ns)
    assert sorted(kineto) == sorted(ours)
    for name, starts in ours.items():
        for a, b in zip(sorted(starts), sorted(kineto[name])):
            assert abs(a - b) < 1_000_000, (name, a - b)


def test_cohort_spans_and_bits_with_and_without_a_profiler():
    """A 2-lane, 2-round cohort on the CPU: the call's spans in order,
    each under the call, and the same history bits with the profiler."""
    plain = build_cohort(ExperimentSpec(**TINY), device="cpu").run()
    assert spans.recorded() == []
    runner = build_cohort(ExperimentSpec(**TINY), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        traced = runner.run()
    got = spans.recorded()
    for field in ("accuracy", "T_k", "E_k", "selected", "mask"):
        np.testing.assert_array_equal(getattr(traced, field),
                                      getattr(plain, field))
    phases = ["fl.select", "fl.allocate", "fl.train", "fl.aggregate",
              "fl.evaluate"]
    initial = ["fl.train", "fl.aggregate", "fl.kmeans"] * 2
    assert _names(got) == (
        ["fl.stack"] + initial + ["fl.initial_round", "fl.draws"]
        + phases + ["fl.round"] + phases + ["fl.round"]
        + ["fl.history", "fl.unstack", "fl.call"])
    call = got[-1]
    assert call.attrs == {"lanes": 2, "rounds": 2} and call.parent is None
    assert all(s.call == call.id for s in got)
    by_id = {s.id: s for s in got}
    rounds = [s for s in got if s.name == "fl.round"]
    assert [s.attrs["round"] for s in rounds] == [1, 2]
    for s in got:
        if s.name in phases or s.name == "fl.kmeans":
            assert by_id[s.parent].name in ("fl.round", "fl.initial_round")
    assert not _names(got, "device") and not _names(got, "replay")


def _lm_clients(n=6, c=2):
    gen = torch.Generator().manual_seed(0)
    g = {"embed": torch.randn(32, 8, generator=gen),
         "w": torch.randn(16, 4, generator=gen)}
    clients = {k: v + 0.01 * torch.randn((n, *v.shape), generator=gen)
               for k, v in g.items()}
    cent = clients["embed"][:c].reshape(c, -1).clone()
    return clients, g, cent, torch.arange(1.0, n + 1.0)


def test_fl_round_step_spans():
    clients, g, cent, sizes = _lm_clients()
    want = fl_round_step(clients, g, cent, sizes, num_clusters=2)
    with profile(activities=[ProfilerActivity.CPU]):
        got_out = fl_round_step(clients, g, cent, sizes, num_clusters=2)
    got = spans.recorded()
    assert _names(got) == ["fl.divergence", "fl.kmeans", "fl.select",
                           "fl.fold"]
    assert all(s.parent is None and s.call == s.id for s in got)
    for a, b in zip(want[1:], got_out[1:]):
        assert torch.equal(a, b)
    for k in want[0]:
        assert torch.equal(want[0][k], got_out[0][k])


def _ring(n, writes):
    """A host ring of ``n`` slots after ``writes``: ``(seq, tag, time)``,
    written in order (a later sequence overwrites its slot)."""
    slots = np.full((n, 3), -1, dtype=np.int64)
    for seq, tag, t in writes:
        slots[seq % n] = (t, seq, tag)
    return slots


def test_ring_decoding_with_a_wrap():
    writes = [(s, 100 + s, 1000 * s) for s in range(11)]  # 11 into 8 slots
    slots = _ring(8, writes)
    got = decode(slots, [(s, 100 + s) for s in (3, 9, 10, 7)])
    np.testing.assert_array_equal(got, [3000, 9000, 10000, 7000])
    assert decode(slots, []).shape == (0,)
    with pytest.raises(RuntimeError, match="overwritten"):
        decode(slots, [(1, 101)])              # slot 1 now holds stamp 9
    with pytest.raises(RuntimeError, match="not tag 7"):
        decode(slots, [(9, 7)])                # the host's count is off
    with pytest.raises(RuntimeError, match="has not run"):
        decode(slots, [(12, 112)])             # not written yet


def test_every_profiler_range_goes_through_span():
    """``record_function`` appears in the port only inside the span
    module."""
    found = [str(p.relative_to(SRC)) for p in SRC.rglob("*.py")
             if re.search(r"record_function\(", p.read_text())]
    assert found == ["utils/spans.py"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamp kernel has no CPU mode")
    return torch.device("cuda")


def _device_records(prof, match=lambda n: True):
    """``(start_ns, end_ns, name)`` of the profile's device work."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.name().startswith(
                ("fl.", "aten::")):
            continue
        if hasattr(e, "is_user_annotation") and e.is_user_annotation():
            continue
        if match(e.name()):
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
    return out


def _spins(bursts=20):
    """Bursts of 16 short spin kernels, each synced and followed by 5 ms
    of host sleep (the benchmark harness's marks)."""
    for _ in range(bursts):
        for _ in range(16):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.005)


def _busy_ns(records):
    total, end = 0, None
    for s, e, _ in sorted(records):
        if end is None or s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total


# how far a host span's edge and the profiler's device records may
# disagree: the profiler converts the card's timestamps to Unix time by
# an approximation (a few tens of µs either way on the H100); the metrics
# that join the two read spans of milliseconds to seconds
CLOCK_SLACK_NS = 250_000
# how far a phase's stamps (%globaltimer) and the profiler's interval
# between its two stamp kernels may disagree: the two clocks drift apart
# by up to ≈ 2 ms within a replay on the H100 (0.1-0.3 ms over a whole
# replay, once 1.86 ms over one 9 ms phase)
STAMP_SLACK_NS = 5_000_000


@pytest.mark.cuda
def test_a_span_holds_its_device_records_on_the_shared_clock(cuda):
    """A host span around a burst of 16 spin kernels of ≈ 0.5 ms each and
    its sync holds every one of their device records, and none of the
    short marks 5 ms before and after it, to within ``CLOCK_SLACK_NS``:
    host spans and the profiler's device records share a clock."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _spins(bursts=3)
        with span("fl.burst"):
            for _ in range(16):
                torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
        time.sleep(0.005)
        _spins(bursts=3)
    (burst,) = spans.recorded()
    spins = sorted(_device_records(prof, lambda n: "spin_kernel" in n))
    long = [r for r in spins if r[1] - r[0] > 100_000]
    marks = [r for r in spins if r[1] - r[0] <= 100_000]
    first, last = long[0][0] - burst.start_ns, burst.end_ns - long[-1][1]
    print(f"span {burst.ms:.3f} ms; its first spin starts {first / 1e3:.1f} "
          f"us after its start, its last ends {last / 1e3:.1f} us before "
          f"its end; {len(marks)} marks kept")
    assert len(long) == 16 and marks
    assert first >= -CLOCK_SLACK_NS and last >= -CLOCK_SLACK_NS
    assert all(e < burst.start_ns - CLOCK_SLACK_NS
               or s > burst.end_ns + CLOCK_SLACK_NS for s, e, _ in marks)


@pytest.mark.cuda
def test_stamps_time_every_phase_of_a_replay(cuda):
    """8 lanes of the paper's round (the seed sweep's shape), captured: a
    replay under the profiler gives its five phases as replay spans; each
    phase's stamps read the trace's interval between its two stamp
    kernels, the phases hold every device record of the replay, and their
    sum is within 5 % of the replay's time on the device (first record to
    last). The stamps change no bit of the runs, and the traced call
    passes the transfer guard."""
    from repro_torch.kernels import stamp as st
    spec = ExperimentSpec(cohort=8, rounds=2)
    runner = build_cohort(spec, device=cuda)
    plain = build_cohort(spec, device=cuda)
    runner.run()
    plain.run()
    launches = st.stamp.launches
    with profile(activities=[ProfilerActivity.CUDA]):
        traced = runner.run(reuse_experiments=True, transfer_guard=True)
    again = plain.run(reuse_experiments=True)
    assert st.stamp.launches > launches
    for field in ("accuracy", "T_k", "E_k", "selected", "mask"):
        np.testing.assert_array_equal(getattr(traced, field),
                                      getattr(again, field))
    got = spans.recorded()
    replays = [s for s in got if s.kind == "replay"]
    phases = ["fl.select", "fl.allocate", "fl.train", "fl.aggregate",
              "fl.evaluate"]
    assert [s.name for s in replays] == phases * 2
    assert sorted({s.attrs["round"] for s in replays}) == [1, 2]
    call = [s for s in got if s.name == "fl.call"][-1]
    assert all(s.call == call.id for s in replays)
    # one replay alone between syncs: its phases against its device records
    prog = runner.program
    spans.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _spins()                       # the profiler drops a profile's
        with span("fl.replay", round=3):    # first device records
            prog.replay(prog.batch.clone())
        torch.cuda.synchronize()
        _spins()
    one = [s for s in spans.recorded() if s.kind == "replay"]
    assert [s.name for s in one] == phases
    records = sorted(_device_records(
        prof, lambda n: "spin_kernel" not in n and "Memcpy" not in n))
    marks = [r for r in records if "fl_stamp_kernel" in r[2]]
    work = [r for r in records if "fl_stamp_kernel" not in r[2]]
    assert len(marks) == 2 * len(phases)
    # each phase: its stamps' interval against the trace's interval
    # between its two stamp kernels, and the device work inside it
    inside = 0
    lines = []
    for k, s in enumerate(one):
        t0, t1 = marks[2 * k][0], marks[2 * k + 1][0]
        assert abs((s.end_ns - s.start_ns) - (t1 - t0)) <= max(
            0.05 * (t1 - t0), STAMP_SLACK_NS), s
        busy = _busy_ns([r for r in work if t0 <= r[0] and r[1] <= t1])
        inside += busy
        lines.append(f"{s.name} {s.ms:.3f} (trace {(t1 - t0) / 1e6:.3f}, "
                     f"busy {busy / 1e6:.3f})")
    stamped = sum(s.end_ns - s.start_ns for s in one)
    busy = _busy_ns(work)
    extent = max(r[1] for r in work) - min(r[0] for r in work)
    print("replay phases [ms]: " + ", ".join(lines)
          + f"; stamped {stamped / 1e6:.3f}, the replay's device records "
          f"first to last {extent / 1e6:.3f}, busy {busy / 1e6:.3f}; "
          f"%globaltimer - trace clock at the stamps [us]: "
          + " ".join(f"{(s.start_ns - marks[2 * k][0]) / 1e3:.1f}"
                     for k, s in enumerate(one)))
    # the phases hold the replay's device work (but the few small kernels
    # of the round's outputs after its last phase), and their stamps its
    # time on the device, gaps between its kernels included
    assert inside >= 0.99 * busy
    assert abs(stamped - extent) <= 0.05 * extent


@pytest.mark.cuda
def test_eager_stamps_only_under_a_profiler(cuda):
    """``fl_round_step`` on the card: no stamp without a profiler; under
    one, each of its four phases as a device span, and the same bits."""
    from repro_torch.kernels import stamp as st
    clients, g, cent, sizes = _lm_clients()
    clients = {k: v.to(cuda) for k, v in clients.items()}
    g = {k: v.to(cuda) for k, v in g.items()}
    cent, sizes = cent.to(cuda), sizes.to(cuda)
    fl_round_step(clients, g, cent, sizes, num_clusters=2)
    launches = st.stamp.launches
    want = fl_round_step(clients, g, cent, sizes, num_clusters=2)
    assert st.stamp.launches == launches
    with profile(activities=[ProfilerActivity.CUDA]):
        got_out = fl_round_step(clients, g, cent, sizes, num_clusters=2)
    dev = [s for s in spans.recorded() if s.kind == "device"]
    assert [s.name for s in dev] == ["fl.divergence", "fl.kmeans",
                                     "fl.select", "fl.fold"]
    assert all(s.end_ns >= s.start_ns for s in dev)
    host = {s.id: s for s in spans.recorded() if s.kind == "host"}
    assert all(host[s.parent].name == s.name for s in dev)
    for a, b in zip(want[1:], got_out[1:]):
        assert torch.equal(a, b)
