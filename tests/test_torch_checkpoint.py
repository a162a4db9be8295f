"""Checkpoint and resume in the port (``tests/test_faults.py``'s cases,
on the CPU).

``repro_torch.train.checkpoint`` writes the reference's layout (a
``leaves.npz`` and a ``manifest.json`` written last, ``LATEST``), so a
snapshot the reference wrote loads through the port and the other way
round. ``FLExperiment.save_checkpoint``/``load_checkpoint`` snapshot the
whole experiment, the draws' generator and the numpy Generator included:
a run killed after 2 rounds and resumed in a fresh experiment repeats the
uninterrupted 4-round run bit for bit — the global row, the history, the
client store and every stats column, fault and strike counts included —
on the dense host loop, the paged loop and the paged asynchronous loop.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as ref_ckpt

from repro_torch.api import ExperimentSpec, build_experiment
from repro_torch.api.scenario import FleetSpec
from repro_torch.core.fedavg import FLHistory
from repro_torch.train import checkpoint as ckpt

TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=3, devices_per_round=4, num_clusters=4,
            learning_rate=0.05, selection="divergence")
PAGED = dict(store="paged", k_max=8, div_refresh_every=1)


# ---------------------------------------------------------------------------
# train/checkpoint.py
# ---------------------------------------------------------------------------


def test_checkpoint_bf16_roundtrip(tmp_path):
    tree = {"w": torch.arange(7, dtype=torch.bfloat16) / 3,
            "b": np.arange(4, dtype=np.float32),
            "nest": {"z": torch.ones(2, 3, dtype=torch.int64),
                     "seq": [np.zeros(1, np.float32), torch.full((2,), 2.5)]}}
    path = str(tmp_path / "snap")
    ckpt.save_checkpoint(path, tree, step=5)
    out = ckpt.load_checkpoint(path, tree)
    assert out["w"].dtype == torch.bfloat16
    # bf16 -> f32 widening is lossless, so the round trip is bitwise
    assert torch.equal(out["w"], tree["w"])
    assert np.array_equal(out["b"], tree["b"])
    assert torch.equal(out["nest"]["z"], tree["nest"]["z"])
    assert torch.equal(out["nest"]["seq"][1], tree["nest"]["seq"][1])
    assert ckpt.checkpoint_step(path) == 5
    assert ckpt.checkpoint_extra(path) == {}
    with pytest.raises(ValueError, match="template"):
        ckpt.load_checkpoint(path, dict(tree, b=np.zeros(5, np.float32)))


def test_checkpoint_manifest_commits_last(tmp_path):
    """A snapshot without a manifest is torn, not committed: readers skip
    it and fall back to the newest complete one."""
    good = str(tmp_path / "round_000002")
    ckpt.save_checkpoint(good, {"x": np.ones(3)}, step=2)
    torn = str(tmp_path / "round_000004")
    os.makedirs(torn)
    np.savez(os.path.join(torn, "leaves.npz"), x=np.zeros(3))
    assert ckpt.is_checkpoint(good) and not ckpt.is_checkpoint(torn)
    # a stale LATEST pointer at the torn snapshot is skipped too
    ckpt.write_latest(str(tmp_path), "round_000004")
    assert ckpt.latest_checkpoint(str(tmp_path)) == good
    assert ckpt.latest_checkpoint(good) == good
    with pytest.raises(FileNotFoundError):
        ckpt.latest_checkpoint(str(tmp_path / "empty"))


def test_checkpoint_no_tmp_litter(tmp_path):
    path = str(tmp_path / "snap")
    ckpt.save_checkpoint(path, {"x": torch.ones(2)}, step=1)
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]
    ckpt.write_latest(str(tmp_path), "snap")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_snapshots_cross_between_the_packages(tmp_path):
    """The reference's snapshot loads through the port's reader, and the
    port's through the reference's: one layout."""
    ref_tree = {"gvec": jnp.linspace(-1, 1, 9),
                "h": jnp.arange(5, dtype=jnp.bfloat16) / 7,
                "stats": {"age": np.arange(4, dtype=np.float32),
                          "avail": np.asarray([True, False, True, True])},
                "key": np.asarray([0, 42], np.uint32)}
    ref_path = str(tmp_path / "ref")
    ref_ckpt.save_checkpoint(ref_path, ref_tree, step=3, extra={"a": 1})
    template = {"gvec": torch.zeros(9),
                "h": torch.zeros(5, dtype=torch.bfloat16),
                "stats": {"age": np.zeros(4, np.float32),
                          "avail": np.zeros(4, bool)},
                "key": np.zeros(2, np.uint32)}
    got = ckpt.load_checkpoint(ref_path, template)
    assert np.array_equal(got["gvec"].numpy(), np.asarray(ref_tree["gvec"]))
    assert np.array_equal(got["h"].float().numpy(),
                          np.asarray(ref_tree["h"], np.float32))
    assert np.array_equal(got["stats"]["avail"], ref_tree["stats"]["avail"])
    assert np.array_equal(got["key"], ref_tree["key"])
    assert ckpt.checkpoint_extra(ref_path) == {"a": 1}
    port_path = str(tmp_path / "port")
    ckpt.save_checkpoint(port_path, got, step=4)
    back = ref_ckpt.load_checkpoint(port_path, ref_tree)
    for k in ("gvec", "h", "key"):
        assert np.array_equal(np.asarray(back[k]), np.asarray(ref_tree[k]))
    with open(os.path.join(ref_path, "manifest.json")) as f, \
            open(os.path.join(port_path, "manifest.json")) as g:
        ref_m, port_m = json.load(f), json.load(g)
    assert ref_m["keys"] == port_m["keys"]
    assert ref_m["dtypes"] == port_m["dtypes"]
    assert ref_m["shapes"] == port_m["shapes"]


def test_history_round_trips():
    exp = build_experiment(ExperimentSpec(**TINY), device="cpu")
    hist = exp.run(rounds=2, target_accuracy=2.0)
    back = FLHistory.from_dict(hist.to_dict())
    for name in FLHistory._ROUNDS:
        a, b = getattr(hist, name), getattr(back, name)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y)), name
    assert back.rounds_to_target == hist.rounds_to_target
    both = FLHistory.from_dict(hist.to_dict()).extend(back)
    assert len(both.accuracy) == 2 * len(hist.accuracy)
    assert both.total_T == pytest.approx(2 * hist.total_T)


# ---------------------------------------------------------------------------
# refusals and routes
# ---------------------------------------------------------------------------


def test_checkpoint_rejects_spec_mismatch(tmp_path):
    spec = ExperimentSpec(**TINY)
    exp = build_experiment(spec, device="cpu")
    exp.run(rounds=2, checkpoint_every=2, checkpoint_dir=str(tmp_path),
            checkpoint_spec=spec.to_dict())
    other = ExperimentSpec(**dict(TINY, learning_rate=0.01))
    fresh = build_experiment(other, device="cpu")
    with pytest.raises(ValueError, match="learning_rate"):
        fresh.load_checkpoint(str(tmp_path), expected_spec=other.to_dict())
    paged = build_experiment(ExperimentSpec(**TINY, **PAGED), device="cpu")
    with pytest.raises(ValueError, match="store='dense'"):
        paged.load_checkpoint(str(tmp_path))


def test_dense_async_checkpoint_unsupported(tmp_path):
    exp = build_experiment(ExperimentSpec(**TINY, aggregator="fedbuff:2"),
                           device="cpu")
    with pytest.raises(ValueError) as info:
        exp.run(rounds=2, checkpoint_every=1, checkpoint_dir=str(tmp_path))
    assert str(info.value) == (
        "the dense buffered-asynchronous engine runs as ONE scanned program "
        "with no host boundary to snapshot at; checkpoint with "
        "store='paged' (the host-composed async loop) or checkpoint_every=0")


def test_stateful_channel_checkpoint_unsupported(tmp_path):
    exp = build_experiment(ExperimentSpec(
        **TINY, fleet=FleetSpec(channel="gauss-markov")), device="cpu")
    with pytest.raises(ValueError) as info:
        exp.run(rounds=2, checkpoint_every=1, checkpoint_dir=str(tmp_path))
    assert str(info.value) == (
        "channel 'gauss-markov' carries fade state only the scanned program "
        "steps; checkpointing drives the host round loop — use the static "
        "channel or checkpoint_every=0")


def test_checkpointed_sync_run_takes_the_host_loop(tmp_path):
    exp = build_experiment(ExperimentSpec(**TINY), device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        exp.run(rounds=1, checkpoint_every=1)
    with pytest.raises(ValueError, match="> 0"):
        exp.run(rounds=1, checkpoint_every=-1, checkpoint_dir=str(tmp_path))
    hist = exp.run(rounds=4, checkpoint_every=1,
                   checkpoint_dir=str(tmp_path))
    assert len(hist.seconds) == 5                 # the host loop's clock
    snaps = sorted(d for d in os.listdir(tmp_path) if d.startswith("round_"))
    assert snaps == ["round_000002", "round_000003", "round_000004"]
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("round_000004")


# ---------------------------------------------------------------------------
# kill and resume, bit for bit
# ---------------------------------------------------------------------------


def _resume_pair(tmp_path, kw, rounds=4, cut=2):
    """``rounds`` uninterrupted; ``cut`` with a snapshot; a FRESH experiment
    restored from it runs the rest."""
    spec = ExperimentSpec(**kw)
    target = None if kw.get("store") == "paged" else 2.0   # the host loop
    full = build_experiment(spec, device="cpu")
    h_full = full.run(rounds=rounds, target_accuracy=target)
    part = build_experiment(spec, device="cpu")
    part.run(rounds=cut, target_accuracy=target, checkpoint_every=cut,
             checkpoint_dir=str(tmp_path), checkpoint_spec=spec.to_dict())
    res = build_experiment(spec, device="cpu")
    rnd, hist = res.load_checkpoint(str(tmp_path),
                                    expected_spec=spec.to_dict())
    assert rnd == cut and len(hist.accuracy) == cut + 1
    h_res = res.run(rounds=rounds - cut, include_initial_round=False,
                    target_accuracy=target, checkpoint_offset=rnd,
                    history=hist)
    return (full, h_full), (res, h_res)


def _same_run(full, h_full, res, h_res):
    for name in ("accuracy", "T_k", "E_k", "band_mhz", "participation",
                 "staleness", "active"):
        assert getattr(h_full, name) == getattr(h_res, name), name
    for a, b in zip(h_full.selected + h_full.per_class,
                    h_res.selected + h_res.per_class):
        assert np.array_equal(a, b)
    assert torch.equal(full.global_vec, res.global_vec)
    for col in full.stats._fields:
        assert np.array_equal(getattr(full.stats, col),
                              getattr(res.stats, col)), col
    for (_, a), (_, b) in zip(full.iter_client_trees(),
                              res.iter_client_trees()):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_checkpoint_resume_dense_sync(tmp_path):
    kw = dict(TINY, faults="outage:0.3,corrupt:0.2", quarantine_after=1,
              aggregator="fedavgm:0.9")
    (full, h_full), (res, h_res) = _resume_pair(tmp_path, kw)
    _same_run(full, h_full, res, h_res)
    assert full.stats.strikes.sum() > 0 and full.stats.faults.sum() > 0


def test_checkpoint_resume_paged(tmp_path):
    kw = dict(TINY, **PAGED, faults="outage:0.3,corrupt:0.2",
              quarantine_after=1, churn_leave=0.1, churn_join=0.3)
    (full, h_full), (res, h_res) = _resume_pair(tmp_path, kw)
    _same_run(full, h_full, res, h_res)
    assert np.array_equal(full.store.touched, res.store.touched)
    assert full.stats.faults.sum() > 0


def test_checkpoint_resume_bit_identical_paged_async(tmp_path):
    """The hardest route (paged + fedbuff + churn + faults + quarantine)."""
    kw = dict(TINY, **PAGED, aggregator="fedbuff:2:0.5",
              faults="outage:0.2,corrupt:0.3", quarantine_after=2,
              churn_leave=0.05, churn_join=0.1)
    (full, h_full), (res, h_res) = _resume_pair(tmp_path, kw)
    _same_run(full, h_full, res, h_res)
    assert full.stats.strikes.sum() > 0
