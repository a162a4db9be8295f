"""Each reference against the port on the CPU at small sizes: the whole
run of every cell comes out correct, and each plain piece agrees with the
port's piece it stands beside."""
import numpy as np
import pytest
import torch

import smoke
from portbench import flcnn, harness
from portbench.reference import data as ref_data
from portbench.reference import fl_round as ref_round
from portbench.reference import sao as ref_sao
from portbench.traffic import lm_clients


@pytest.mark.parametrize("cell", ["qwen2-round16", "cnn-sweep8"])
def test_small_run_is_correct(cell):
    out = smoke.run(cell)
    assert out["correct"], harness.check_lines(out["checks"])
    assert out["attempted"] > 0
    want = harness.cell_metrics(harness.benchmark(), cell, "end_to_end")
    assert {m["name"] for m in want} == set(out["metrics"])


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_data_copies_are_the_ports(seed):
    from repro_torch.core.wireless import sample_fleet
    from repro_torch.data.partition import partition_bias
    from repro_torch.data.synthetic import make_dataset
    ds = make_dataset("fashion", 120, seed=seed)
    x, y = ref_data.make_dataset("fashion", (28, 28), 1, 10, 120, seed)
    assert np.array_equal(ds.images, x) and np.array_equal(ds.labels, y)
    fed = partition_bias(ds, 6, 16, 0.8, seed=seed + 1)
    images, labels, sizes = ref_data.partition_bias(x, y, 10, 6, 16, 0.8,
                                                    seed + 1)
    assert np.array_equal(fed.images, images)
    assert np.array_equal(fed.labels, labels)
    assert np.array_equal(fed.sizes, sizes)
    fl = sample_fleet(9, seed=seed)
    want = {"J": fl.J_mhz(), "U": fl.U_gcycles(), "G": fl.G_joule_per_ghz2(),
            "H": fl.H_joule(), "z": fl.z, "e_cons": fl.e_cons,
            "f_min": fl.f_min, "f_max": fl.f_max}
    got = ref_data.fleet(9, seed)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-15, err_msg=k)


@pytest.mark.parametrize("seed", [0, 11, 2**31 + 5])
def test_sao_reference_is_the_ports_solve(seed):
    from repro_torch.core.sao import solve_sao
    from repro_torch.core.wireless import effective_arrays, fleet_arrays
    from repro_torch.core.wireless import sample_fleet
    fl = sample_fleet(10, seed=seed)
    arr = effective_arrays(fleet_arrays(fl))
    s = solve_sao(arr, 20.0)
    e = (arr["G"] * s.f ** 2 + arr["H"] / (s.b * torch.log2(
        1 + arr["J"] / s.b))).sum()
    T, E, b, f = ref_sao.solve(ref_data.fleet(10, seed), 20.0)
    assert abs(float(s.T) - T) / T < 2e-3
    assert abs(float(e) - E) / E < 2e-3
    assert abs(float(s.b.sum()) - b.sum()) / b.sum() < 2e-3


def test_fl_round_reference_is_the_ports_round():
    from repro_torch.launch.fl_round import fl_round_step
    _, cfg, tr = smoke.inputs("qwen2-round16")
    g, clients, cent, sizes = lm_clients(cfg, tr, 5, "cpu")
    got = fl_round_step(clients, g, cent, sizes, num_clusters=4)
    nums = ref_round.check_round(clients, g, cent, sizes, 4, got, block=999)
    assert nums["div_gap"] < 1e-5 and nums["fold_gap"] < 4e-3
    assert nums["labels_differ"] == nums["winners_differ"] == 0
    assert nums["dtype_differ"] == 0


def test_lm_clients_repeat_from_their_seed():
    _, cfg, tr = smoke.inputs("qwen2-round16")
    a = lm_clients(cfg, tr, 9, "cpu")
    b = lm_clients(cfg, tr, 9, "cpu")
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k])
    assert torch.equal(a[2], b[2])
    assert not torch.equal(a[1]["embed"],
                           lm_clients(cfg, tr, 10, "cpu")[1]["embed"])


def test_cnn_reference_round_follows_the_port():
    """One host-loop round of the port against the reference's pieces
    from the same row, plane and labels: Alg. 4, SAO, local SGD, the fold
    and the accuracy."""
    from repro_torch.api import build_experiment
    from portbench.traffic import SeedDraws
    _, cfg, tr = smoke.inputs("cnn-sweep8")
    draws = SeedDraws(4, "cpu", cfg["model"])
    exp = build_experiment(flcnn.spec_of(cfg, tr, 4), device="cpu",
                           draws=draws)
    exp.initial_round()
    g0, plane0 = exp.global_vec.clone(), exp.client_plane.clone()
    labels = np.array(exp.cluster_labels)
    res = exp.round()
    sel = np.asarray(res.selected)
    lane = flcnn.reference_lane(cfg, 4, "cpu")
    assert lane.selection_gap(g0, plane0, labels, sel) == 0.0
    T, E = lane.allocate(sel, len(sel))
    assert abs(res.T_k - T) / T < 2e-3 and abs(res.E_k - E) / E < 2e-3
    rows = lane.train(g0, sel, draws.batches[-1])
    assert float((rows - exp.client_plane[sel]).norm() / rows.norm()) < 1e-5
    g = lane.fold(exp.client_plane[sel], sel)
    assert float((exp.global_vec - g).norm() / g.norm()) < 1e-6
    low, high = lane.accuracy(exp.global_vec)
    assert low - 1e-6 <= res.accuracy <= high + 1e-6     # fp32 of k/n
