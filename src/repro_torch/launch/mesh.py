"""Meshes as records, and the card's peaks (the port of
``repro.launch.mesh``).

A ``Mesh`` is what the partition rules read (``axis_names``, ``shape``)
and the devices it spans. Building one touches no device: the production
meshes are logical (a 256- or 512-card layout the rules are held to), and
a host mesh names the cards or the CPU this process may use. The port has
no SPMD partitioner: a logical mesh is never run. Over a host mesh of
several positions the port splits three paths by hand: a seed cohort's
lanes (``core.cohort``), the ``[N, P]`` plane's columns (``p_shards``,
``sharding.blocks``) and ``lower_fl_round``'s clients. Work is keyed by a
device's position in ``devices``, never by the device itself, so a mesh
may name one device more than once (as the reference's tests force
several host devices out of one CPU) and runs the code a mesh over
distinct cards runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    """``axis_names`` in order, ``shape`` (``{name: size}``) and
    ``devices``: an object array of ``torch.device`` of the mesh's
    shape. ``logical``: a pod's layout whose devices this host need not
    have (:func:`make_logical_mesh`): rules and counts read it, nothing
    runs on it."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: np.ndarray
    logical: bool = False

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _mesh(devices, sizes, axes, logical: bool = False) -> Mesh:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(tuple(axes), dict(zip(axes, sizes)),
                arr.reshape(tuple(sizes)), logical)


def make_logical_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over the axes ``axes`` whose devices are
    ``cuda:0 …`` of a logical pod: no device is touched."""
    n = int(np.prod(shape))
    return _mesh([torch.device("cuda", i) for i in range(n)], tuple(shape),
                 tuple(axes), logical=True)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 ``("data", "model")`` (one pod, 256 cards) or 2×16×16 with
    ``"pod"`` in front (512), logical (:func:`make_logical_mesh`)."""
    if multi_pod:
        return make_logical_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_logical_mesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda") -> Mesh:
    """A ``("data", "model")`` mesh over the cards of this host
    (``torch.cuda.device_count()``), or over the one CPU device when
    ``device`` is the CPU; sizes shrink to what exists, as in the
    reference. A CUDA mesh with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device: make_host_mesh(device='cpu') "
                               "builds the CPU's one-device mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        n, devices = 1, [dev]
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    return _mesh(devices[:data * model], (data, model), ("data", "model"))


# NVIDIA H100 SXM5 80GB HBM3, from its data sheet, at its 700 W power limit
# (a card set below it runs slower under load). Dense rates, no sparsity.
# The reference's keys; the link between cards is NVLink.
H100_SXM = {
    "peak_bf16_flops": 989e12,        # bf16 tensor cores, FLOP/s
    "hbm_bandwidth": 3.35e12,         # bytes/s
    "ici_bandwidth": 450e9,           # NVLink, bytes/s each direction
    "hbm_bytes": 80e9,
    "peak_tf32_flops": 495e12,        # TF32 tensor cores, FLOP/s
    "peak_fp32_flops": 67e12,         # fp32 outside the tensor cores
}
