"""``ExperimentSpec.p_shards`` and the cohort mesh on one device
(``repro_torch.sharding.specs.plane_mesh``, ``repro_torch.core.cohort``);
over meshes of several positions (the plane's columns in blocks, a
cohort's lanes split, ``lower_fl_round`` on ``data > 1``):
``tests/test_torch_multi_device.py``. On one device:

(a) the spec field as the reference's: default 0, the JSON form, and
    ``p_shards=-1`` refused with the reference's words;
(b) ``plane_mesh`` off at 0 and a one-device ``model`` mesh above
    (``test_lm.py::test_plane_mesh_off_and_degenerate``), whose shardings
    replicate every carry leaf;
(c) ``ExperimentSpec(p_shards=4)`` on the CPU is the ``p_shards=0`` run
    bit for bit (the device-resident run: selections, T_k/E_k, accuracy,
    the global row, the plane, the labels), and is held to the
    reference's run with ``p_shards=4`` (one CPU device, so its mesh is
    degenerate too) on the reference's key stream, at
    ``test_torch_traced.py``'s bands;
(d) the cohort mesh: ``_mesh_pad``'s arithmetic
    (``test_channel_dynamics.py::test_mesh_pad_arithmetic``), no mesh on
    one device, and ``_shard_cohort`` the identity without one.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as RefSpec
from repro.api import build_experiment as ref_build_experiment
from repro.utils.trees import tree_flatten_vector

from repro_torch.api import ExperimentSpec, build_experiment
from repro_torch.core.cohort import _mesh_pad, _shard_cohort, cohort_mesh
from repro_torch.sharding.specs import (device_put, plane_mesh,
                                        plane_shardings)
from test_torch_slice import SPEC, JaxReplayDraws


def test_the_spec_field_is_the_reference_s():
    assert ExperimentSpec().p_shards == RefSpec().p_shards == 0
    spec = ExperimentSpec(**SPEC, p_shards=4)
    assert spec.to_dict() == RefSpec(**SPEC, p_shards=4).to_dict()
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    for cls in (ExperimentSpec, RefSpec):
        with pytest.raises(ValueError, match=r"p_shards must be >= 0; got -1"):
            cls(p_shards=-1)


def test_plane_mesh_off_and_degenerate():
    assert plane_mesh(0, "cpu") is None
    mesh = plane_mesh(4, "cpu")                 # one CPU device
    assert mesh.shape == {"model": 1} and mesh.axis_names == ("model",)
    carry = {"params": torch.ones(12), "plane": torch.ones(5, 12),
             "labels": torch.zeros(5, dtype=torch.long), "none": None}
    shards = plane_shardings(carry, mesh, 12)
    assert all(s.spec == (None,) * carry[k].dim()
               for k, s in shards.items() if k != "none")
    placed = device_put(carry, shards)
    assert all(placed[k] is carry[k] for k in carry)


@pytest.fixture(scope="module")
def runs():
    """The port's run at p_shards 0 and 4 and the reference's at 4, each
    on the reference's key stream."""
    out = {}
    for k in (0, 4):
        exp = build_experiment(ExperimentSpec(**SPEC, p_shards=k),
                               device="cpu", draws=JaxReplayDraws(0))
        out[k] = (exp, exp.run())
        assert out[k][1].seconds == []          # the device-resident run
    assert out[0][0].plane_mesh is None
    assert out[4][0].plane_mesh.shape == {"model": 1}
    ref = ref_build_experiment(RefSpec(**SPEC, p_shards=4))
    return out, (ref, ref.run())


def test_p_shards_is_the_unsharded_run_bit_for_bit(runs):
    (e0, h0), (e4, h4) = runs[0][0], runs[0][4]
    assert h4.accuracy == h0.accuracy
    assert h4.T_k == h0.T_k and h4.E_k == h0.E_k
    for a, b in zip(h4.selected, h0.selected):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(e4.global_vec, e0.global_vec)
    assert torch.equal(e4.client_plane, e0.client_plane)
    np.testing.assert_array_equal(e4.cluster_labels, e0.cluster_labels)


def test_p_shards_matches_the_reference(runs):
    (port, h_port), (ref, h_ref) = runs[0][4], runs[1]
    for a, b in zip(h_port.selected, h_ref.selected):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(h_port.T_k, h_ref.T_k, rtol=2e-3)
    np.testing.assert_allclose(h_port.E_k, h_ref.E_k, rtol=2e-3)
    for a, b in zip(h_port.accuracy, h_ref.accuracy):
        assert abs(a - b) <= 1.0 / SPEC["test_samples"] + 1e-6
    np.testing.assert_allclose(
        port.global_vec.numpy(),
        np.asarray(tree_flatten_vector(ref.global_params)), atol=1e-4)


def test_cohort_mesh_on_one_device():
    class Stub:
        devices = np.zeros(6)

    assert _mesh_pad(8, Stub()) == 4
    assert _mesh_pad(12, Stub()) == 0
    assert _mesh_pad(5, Stub()) == 1
    assert _mesh_pad(3, None) == 0
    assert cohort_mesh(8, "cpu") is None
    tree = {"a": torch.ones(3)}
    assert _shard_cohort(tree, None) is tree
