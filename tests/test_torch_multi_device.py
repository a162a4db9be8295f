"""The port's three paths over several mesh positions, on the CPU, with
meshes that name the CPU device 2 and 4 times (work goes by position, so
a repeated device runs the code distinct cards run; the tests replace
``cohort_mesh`` and ``plane_mesh`` as the reference's own test replaces
``cohort.cohort_mesh``):

(a) ``ExperimentSpec(p_shards=m)``, m = 2 and 4: the plane's columns in
    m blocks, one a position, equal to the ``p_shards=0`` run bit for bit
    in selections, T_k, E_k, accuracy, the global row, the assembled
    plane and the labels (a feature layer straddling the blocks' bounds
    among them), the divergences from the positions' partials within
    rtol 1e-5; the blocks kept between runs; ``P % m != 0`` and the
    buffered-asynchronous tick replicate (``plane_split`` 1);
(b) a seed cohort split over 2 and 4 positions, padded and stripped:
    every lane equal to the one-device cohort's and to its seed's single
    run bit for bit; a dynamic 2-cell cohort keeps a seed's cells on one
    position; FedBuff ticks and LoRA-LM lanes split too;
(c) ``lower_fl_round(...).compile`` on a host mesh of ``data = 2`` and 4
    positions: divergences and labels the one-position compile's bit for
    bit, the new global row within 1e-6 relative (bf16 clients: ROADMAP's
    bf16 bands); a logical production mesh and a ``model > 1`` host mesh
    still refuse;
(d) the reference over 2 forced host devices (one subprocess, started
    when the module starts): ``p_shards=2`` and a cohort of 3 on
    ``test_torch_slice.SPEC``, against the port's runs on the reference's
    key streams at ``test_torch_traced.py``'s bands.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.core.cohort as cohort
from repro_torch.api import ExperimentSpec, build_cohort, build_experiment
from repro_torch.api.scenario import multicell_fleet_spec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.fl_round import fl_round_step, lower_fl_round
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.sharding import specs as sh
from repro_torch.sharding.blocks import ColumnBlocks
from test_torch_fl_round import _setup
from test_torch_slice import SPEC, JaxReplayDraws

CPU = torch.device("cpu")
# the paper's MNIST CNN (P = 113,744 divides 2 and 4) at a tiny data size
MNIST = dict(SPEC, dataset="mnist")


def repeated(axes, sizes, device=CPU) -> Mesh:
    """A mesh over one device named at every position."""
    n = int(np.prod(sizes))
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(device)] * n
    return Mesh(tuple(axes), dict(zip(axes, sizes)), arr.reshape(sizes))


@pytest.fixture
def positions(monkeypatch):
    """``positions(m)``: the host has ``m`` positions, all the CPU:
    ``plane_mesh`` and ``cohort_mesh`` build over ``min(asked, m)``."""
    def use(m):
        monkeypatch.setattr(sh, "plane_mesh", lambda p, device="cuda": (
            None if p <= 0 else repeated(("model",), (min(p, m),))))
        monkeypatch.setattr(cohort, "cohort_mesh", lambda n, device="cuda": (
            None if min(n, m) <= 1 else repeated(("cohort",), (min(n, m),))))
    return use


# ---------------------------------------------------------------------------
# (d) the reference, started first: it runs beside the port's cases
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    assert len(jax.devices()) == 2, jax.devices()
    from repro.api import ExperimentSpec, build_cohort, build_experiment
    from repro.utils.trees import tree_flatten_vector

    spec = json.loads(sys.argv[1])
    def row(exp):
        return np.asarray(tree_flatten_vector(exp.global_params)).tolist()
    exp = build_experiment(ExperimentSpec(**spec, p_shards=2))
    h = exp.run()
    out = {"p_shards": dict(
        selected=[np.asarray(s).tolist() for s in h.selected], T_k=h.T_k,
        E_k=h.E_k, accuracy=h.accuracy, row=row(exp),
        devices=len(exp.client_params.sharding.device_set))}
    runner = build_cohort(ExperimentSpec(**spec, cohort=3))
    ch = runner.run()
    out["cohort"] = dict(
        selected=[[np.asarray(s).tolist() for s in ch.history(i).selected]
                  for i in range(len(ch))],
        T_k=np.asarray(ch.T_k).tolist(), E_k=np.asarray(ch.E_k).tolist(),
        accuracy=np.asarray(ch.accuracy).tolist(),
        rows=[row(e) for e in runner.experiments])
    print("REFERENCE " + json.dumps(out))
""")


@pytest.fixture(scope="module", autouse=True)
def reference_process():
    """The reference over 2 forced host devices, in a subprocess started
    with the module (it takes about 45 s; the port's cases run beside
    it)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=2")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.join(os.path.dirname(__file__), "..", "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE,
                             json.dumps(SPEC)], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_process):
    out, err = reference_process.communicate(timeout=600)
    line = [ln for ln in out.splitlines() if ln.startswith("REFERENCE ")]
    assert line, out + "\n" + err
    return json.loads(line[-1][len("REFERENCE "):])


# ---------------------------------------------------------------------------
# (a) the plane's columns over a model mesh
# ---------------------------------------------------------------------------


def _run(spec, **kw):
    exp = build_experiment(spec, device="cpu", **kw)
    return exp, exp.run()


def _assert_same_run(a, ha, b, hb):
    assert ha.seconds == hb.seconds == []          # device-resident runs
    assert ha.accuracy == hb.accuracy
    assert ha.T_k == hb.T_k and ha.E_k == hb.E_k
    assert len(ha.selected) == len(hb.selected)
    for x, y in zip(ha.selected, hb.selected):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(a.global_vec, b.global_vec)
    assert torch.equal(a.client_plane, b.client_plane)
    np.testing.assert_array_equal(a.cluster_labels, b.cluster_labels)


@pytest.mark.parametrize("m,layer", [(2, "auto"), (4, "w_fc1")])
def test_p_shards_is_the_unsharded_run_bit_for_bit(positions, m, layer):
    """``w_fc1`` (columns 11,152–111,504) straddles every block bound."""
    positions(m)
    spec = ExperimentSpec(**MNIST, feature_layer=layer)
    e0, h0 = _run(spec)
    em, hm = _run(spec.replace(p_shards=m))
    assert e0.plane_split == 1 and em.plane_split == m
    _assert_same_run(em, hm, e0, h0)
    # between runs the experiment keeps the blocks, one a position
    plane = em.store.buffer
    assert isinstance(plane, ColumnBlocks) and len(plane.blocks) == m
    p = em.flat_spec.total
    assert [tuple(b.shape) for b in plane.blocks] == [(MNIST["clients"],
                                                       p // m)] * m
    assert plane.bounds == tuple((i * p // m, (i + 1) * p // m)
                                 for i in range(m))
    assert plane.devices == (CPU,) * m
    # a second run continues from the blocks, as the unsharded one does
    _assert_same_run(em, em.run(rounds=1, include_initial_round=False), e0,
                     e0.run(rounds=1, include_initial_round=False))


def test_divergence_from_the_positions_partials(positions):
    """The round's divergence: each position's partial over its columns,
    summed on the lead in position order — the whole plane's within rtol
    1e-5; the features gathered across a block bound are the columns."""
    from repro_torch.core.engine import build_round_phases
    positions(4)
    exp, _ = _run(ExperimentSpec(**dict(MNIST, rounds=1), p_shards=4))
    ph = build_round_phases(exp.engine_cfg, exp.aggregator, exp.selector,
                            exp.allocator, exp.traced_context(),
                            exp.fl.feature_layer)
    state = exp._place_carry(exp.traced_state())
    assert isinstance(state.client_params, ColumnBlocks)
    ph.flush(state, write=False)
    parts = state.client_params.partials
    assert len(parts) == 4 and all(t.device == CPU for t in parts)
    got = torch.sqrt(parts[0] + parts[1] + parts[2] + parts[3])
    whole = exp.client_plane
    want = ops.client_divergence(whole, exp.global_vec)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    cols = slice(28_000, 30_000)                 # across the bound 28,436
    assert torch.equal(state.client_params.columns(cols, 8), whole[:, cols])


def test_p_shards_that_do_not_divide_replicate(positions):
    """``P = 19,522`` over 4 positions does not divide: the reference's
    ``plane_spec`` replicates, and so does the port (``plane_split`` 1,
    the plane whole on the lead); so does the asynchronous tick."""
    positions(4)
    e0, h0 = _run(ExperimentSpec(**SPEC))
    e4, h4 = _run(ExperimentSpec(**SPEC, p_shards=4))
    assert e4.plane_mesh.shape == {"model": 4} and e4.plane_split == 1
    assert isinstance(e4.store.buffer, torch.Tensor)
    _assert_same_run(e4, h4, e0, h0)
    tick = dict(SPEC, aggregator="fedbuff:2:0.5")
    a0, g0 = _run(ExperimentSpec(**tick))
    a2, g2 = _run(ExperimentSpec(**tick, p_shards=2))
    assert a2.plane_split == 1
    _assert_same_run(a2, g2, a0, g0)


def test_the_host_loop_joins_the_blocks(positions):
    """The host loop ignores ``p_shards`` (as the reference's does): it
    joins the blocks on the lead first and runs as the unsharded
    experiment's host loop."""
    positions(2)
    e0, _ = _run(ExperimentSpec(**dict(MNIST, rounds=1)))
    e2, _ = _run(ExperimentSpec(**dict(MNIST, rounds=1), p_shards=2))
    assert isinstance(e2.store.buffer, ColumnBlocks)
    r0, r2 = e0.round(), e2.round()
    np.testing.assert_array_equal(r0.selected, r2.selected)
    assert r0.T_k == r2.T_k and r0.accuracy == r2.accuracy
    assert isinstance(e2.store.buffer, torch.Tensor)
    assert torch.equal(e2.client_plane, e0.client_plane)


def test_column_blocks_place_read_and_write():
    """``device_put`` of a plane leaf by its ``plane_spec`` over 3
    positions: contiguous column blocks, each its own copy; rows read and
    written through them as the client store does; a replicated leaf
    whole on the lead; a split the port does not make raises."""
    mesh = repeated(("model",), (3,))
    x = torch.arange(5 * 12, dtype=torch.float32).reshape(5, 12)
    blocks = sh.device_put(x, sh.plane_shardings(x, mesh, 12))
    assert isinstance(blocks, ColumnBlocks)
    assert blocks.bounds == ((0, 4), (4, 8), (8, 12))
    assert all(b.data_ptr() != x.data_ptr() for b in blocks.blocks)
    assert blocks.shape == (5, 12) and blocks.numel() == 60
    assert blocks.ndim == 2 and blocks.device == CPU
    assert torch.equal(blocks.assemble(), x)
    assert torch.equal(blocks[1:3], x[1:3])
    assert torch.equal(blocks[torch.tensor([4, 0])], x[[4, 0]])
    assert torch.equal(blocks.columns(slice(3, 9), 4), x[:4, 3:9])
    assert sh.device_put(blocks, sh.plane_shardings(blocks, mesh, 12)) \
        is blocks
    rows = -torch.ones(2, 12)
    blocks.index_copy_(0, torch.tensor([0, 3]), rows)
    x[[0, 3]] = rows
    assert torch.equal(blocks.assemble(), x)
    assert torch.equal(blocks.padded(2).assemble()[:5], x)
    assert torch.equal(blocks.head(2).assemble(), x[:2])
    row = torch.ones(12)
    assert sh.device_put(row, sh.lead_shardings(row, mesh)) is row
    with pytest.raises(NotImplementedError, match="last dim"):
        sh.device_put(x, sh.NamedSharding(mesh, sh.P("model", None)))
    assert cohort.cohort_mesh(8, "cpu") is None
    shares = cohort._shard_cohort(list(range(6)),
                                  repeated(("cohort",), (3,)))
    assert shares == [[0, 1], [2, 3], [4, 5]]


def test_checkpoint_of_a_split_plane(positions, tmp_path):
    """A snapshot taken while the experiment keeps its plane as blocks
    restores into a fresh experiment that holds it whole."""
    positions(2)
    e2, _ = _run(ExperimentSpec(**dict(MNIST, rounds=1), p_shards=2))
    assert isinstance(e2.store.buffer, ColumnBlocks)
    path = e2.save_checkpoint(str(tmp_path), round_idx=1)
    fresh = build_experiment(ExperimentSpec(**dict(MNIST, rounds=1)),
                             device="cpu")
    fresh.load_checkpoint(path)
    assert torch.equal(fresh.client_plane, e2.client_plane)
    assert torch.equal(fresh.global_vec, e2.global_vec)


# ---------------------------------------------------------------------------
# (b) a seed cohort over positions
# ---------------------------------------------------------------------------


def _same_history(a, b):
    for name in ("accuracy", "T_k", "E_k", "selected", "mask"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for name in ("inr", "participation", "staleness", "active"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y)


def _same_lanes(ra, rb):
    for a, b in zip(ra.experiments, rb.experiments):
        assert torch.equal(a.global_vec, b.global_vec)
        assert torch.equal(a.client_plane, b.client_plane)
        np.testing.assert_array_equal(a.cluster_labels, b.cluster_labels)


@pytest.mark.parametrize("m,lanes", [(2, 3), (4, 5)])
def test_cohort_split_is_the_one_device_cohort(positions, m, lanes):
    """3 lanes over 2 positions (1 pad lane), 5 over 4 (3 pads): every
    lane the one-device cohort's and its seed's single run, bit for
    bit."""
    spec = ExperimentSpec(**SPEC, cohort=lanes)
    one = build_cohort(spec, device="cpu")
    ch1 = one.run()
    positions(m)
    split = build_cohort(spec, device="cpu")
    ch = split.run()
    assert len(split.programs) == m and len(split._pads) == (-lanes) % m
    assert ch.accuracy.shape == (lanes, SPEC["rounds"] + 1)
    assert [p.lanes for p in split.programs] == [(lanes + (-lanes) % m) // m
                                                 ] * m
    _same_history(ch, ch1)
    _same_lanes(split, one)
    i = lanes - 1
    single, h = _run(spec.replace(seed=ch.seeds[i]))
    hi = ch.history(i)
    assert hi.accuracy == h.accuracy and hi.T_k == h.T_k
    for a, b in zip(hi.selected, h.selected):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(split.experiments[i].global_vec, single.global_vec)


def test_dynamic_cells_of_a_seed_stay_on_one_position(positions):
    """3 seeds × 2 cells under ``multicell-dynamic`` over 2 positions:
    the lane groups are seeds (their cells coupled inside the round), so
    position 0 runs seeds 0 and 1's four lanes and position 1 seed 2's
    two and a pad seed's two; the history is the one-device cohort's."""
    spec = ExperimentSpec(**dict(SPEC, rounds=1), cohort=3,
                          fleet=multicell_fleet_spec(
                              2, channel="multicell-dynamic"))
    one = build_cohort(spec, device="cpu")
    ch1 = one.run()
    positions(2)
    split = build_cohort(spec, device="cpu")
    ch = split.run()
    assert [p.lanes for p in split.programs] == [4, 4]
    assert all(p.ph.cells == 2 and p.ph.dynamic for p in split.programs)
    assert [e.spec.seed for e in split._pads] == [2, 2]
    assert ch.inr.shape == (6, 1)
    _same_history(ch, ch1)
    _same_lanes(split, one)


def test_fedbuff_cohort_splits(positions):
    """FedBuff ticks under churn, a cohort of 2 over 2 positions."""
    spec = ExperimentSpec(**dict(SPEC, rounds=3), cohort=2,
                          aggregator="fedbuff:2:0.5", churn_leave=0.2,
                          churn_join=0.3)
    one = build_cohort(spec, device="cpu")
    ch1 = one.run()
    positions(2)
    split = build_cohort(spec, device="cpu")
    ch = split.run()
    assert len(split.programs) == 2 and ch.participation.shape == (2, 3)
    _same_history(ch, ch1)
    _same_lanes(split, one)


def test_lm_cohort_splits(positions):
    """LoRA-LM lanes (tinyllama's smoke width), a cohort of 2 over 2
    positions, the frozen base beside each position's lanes."""
    spec = ExperimentSpec(model="tinyllama", clients=6, train_samples=48,
                          test_samples=16, samples_per_client=8,
                          devices_per_round=2, num_clusters=2, local_iters=2,
                          batch_size=4, rounds=1, learning_rate=0.1,
                          cohort=2, test_seed=5)
    one = build_cohort(spec, device="cpu")
    ch1 = one.run()
    positions(2)
    split = build_cohort(spec, device="cpu")
    ch = split.run()
    assert len(split.programs) == 2
    _same_history(ch, ch1)
    _same_lanes(split, one)


# ---------------------------------------------------------------------------
# (c) lower_fl_round on a host mesh of several positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2, 4])
def test_lower_fl_round_splits_its_clients(d, dtype):
    n, c = 8, 3
    cfg = get_smoke_config("tinyllama-1.1b")
    _, g, clients, cent, sizes = _setup(n, c, dtype)
    lo = lower_fl_round(cfg, repeated(("data", "model"), (d, 1)),
                        num_clients=n, num_clusters=c)
    step = lo.compile("cpu")
    assert lo.positions == d
    got_g, div, labels = step(clients, g, cent, sizes)
    want_g, want_div, want_labels = fl_round_step(clients, g, cent, sizes,
                                                  num_clusters=c)
    assert torch.equal(div, want_div) and torch.equal(labels, want_labels)
    for k, want in want_g.items():
        assert got_g[k].dtype == want.dtype and got_g[k].shape == want.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(got_g[k].numpy(), want.numpy(),
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(got_g[k].float().numpy(),
                                       want.float().numpy(), rtol=3e-2,
                                       atol=3e-1)


def test_lower_fl_round_refusals_and_replication():
    cfg = get_smoke_config("tinyllama-1.1b")
    _, g, clients, cent, sizes = _setup(6, 3)
    # 6 clients over 4 positions: the spec replicates them, and the
    # compiled round runs whole on the lead
    lo = lower_fl_round(cfg, repeated(("data", "model"), (4, 1)),
                        num_clients=6, num_clusters=3)
    step = lo.compile("cpu")
    assert lo.positions == 1
    got = step(clients, g, cent, sizes)
    want = fl_round_step(clients, g, cent, sizes, num_clusters=3)
    assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
    with pytest.raises(NotImplementedError, match="SPMD"):
        lower_fl_round(cfg, repeated(("data", "model"), (2, 2)),
                       num_clients=8).compile("cpu")
    for multi in (False, True):
        with pytest.raises(NotImplementedError, match="SPMD"):
            lower_fl_round(get_config("tinyllama-1.1b"),
                           make_production_mesh(multi_pod=multi),
                           num_clients=512).compile("cuda")


# ---------------------------------------------------------------------------
# (d) against the reference over 2 forced host devices
# ---------------------------------------------------------------------------


def _held_to_reference(selected, T_k, E_k, accuracy, row, ref):
    for a, b in zip(selected, ref["selected"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(T_k, ref["T_k"], rtol=2e-3)
    np.testing.assert_allclose(E_k, ref["E_k"], rtol=2e-3)
    np.testing.assert_allclose(accuracy, ref["accuracy"], rtol=0,
                               atol=1.0 / SPEC["test_samples"] + 1e-6)
    np.testing.assert_allclose(row, ref["row"], atol=1e-4)


def test_p_shards_matches_the_reference_on_two_devices(positions, reference):
    ref = reference["p_shards"]
    assert ref["devices"] == 2
    positions(2)
    exp, h = _run(ExperimentSpec(**SPEC, p_shards=2),
                  draws=JaxReplayDraws(0))
    assert exp.plane_split == 2
    _held_to_reference(h.selected, h.T_k, h.E_k, h.accuracy,
                       exp.global_vec.numpy(), ref)


def test_cohort_matches_the_reference_on_two_devices(positions, reference):
    ref = reference["cohort"]
    positions(2)
    runner = build_cohort(ExperimentSpec(**SPEC, cohort=3), device="cpu",
                          draws=JaxReplayDraws)
    ch = runner.run()
    assert len(runner.programs) == 2
    for i in range(3):
        _held_to_reference(
            ch.history(i).selected, ch.T_k[i], ch.E_k[i], ch.accuracy[i],
            runner.experiments[i].global_vec.numpy(),
            dict(selected=ref["selected"][i], T_k=ref["T_k"][i],
                 E_k=ref["E_k"][i], accuracy=ref["accuracy"][i],
                 row=ref["rows"][i]))
