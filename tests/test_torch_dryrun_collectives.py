"""The dry run's collectives and peak memory (``repro_torch.sharding.
partition``, ``repro_torch.roofline.analysis.PeakMemory``), on the CPU:

(a) the byte convention on hand-built DTensors: an all-gather counts its
    gathered result, an all-reduce its tensor once, a reduce-scatter its
    scattered part, each on one device (the reference's result bytes);
(b) ``PeakMemory``: frees, views, autograd's saved tensors, remat; the
    kernels' allocations on ``meta`` in place of the plain attention's
    scores, with no launch counted;
(c) the mesh's axes as DTensor's dims, and a refused layout run
    replicated;
(d) records on the production meshes: the collective bytes filled and
    positive, their kinds summing to the total, the collective term in
    the bottleneck, the tracked peak at least the old lower bound;
(e) two small combinations that compile on the CPU against the
    reference's ``collective_bytes`` (``tests/collectives_vs_reference.
    py``): the totals within a factor of 8 either way (``PERF.md``'s
    dry-run table states each factor and why it leaves 0.5-2), both
    sides gathering and reducing.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import os
import sys

import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.build import kernel_allocations
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import H100_SXM, make_logical_mesh
from repro_torch.roofline.analysis import peak_memory
from repro_torch.sharding import partition
from repro_torch.sharding.specs import NamedSharding, P

sys.path.insert(0, os.path.dirname(__file__))
import collectives_vs_reference as vs_ref  # noqa: E402

META = torch.device("meta")
MB = 2 ** 20


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# (a) the byte convention
# ---------------------------------------------------------------------------


def test_collective_bytes_are_result_bytes_on_one_device():
    mesh = make_logical_mesh((2, 4), ("data", "model"))
    count = partition.CollectiveBytes()
    with partition.fake_device_mesh(mesh) as dm:
        x = DTensor.from_local(_meta(4, 16), dm, [Shard(0), Replicate()],
                               run_check=False, shape=(8, 16),
                               stride=(16, 1))
        y = DTensor.from_local(_meta(8, 16), dm, [Replicate(), Partial()],
                               run_check=False, shape=(8, 16),
                               stride=(16, 1))
        with count:
            x.redistribute(dm, [Replicate(), Replicate()])     # gather
            y.redistribute(dm, [Replicate(), Replicate()])     # reduce
            y.redistribute(dm, [Replicate(), Shard(1)])        # scatter
    rec = count.record()
    assert rec["counts"] == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "collective-permute": 0}
    assert rec["all-gather"] == 8 * 16 * 4          # the gathered [8, 16]
    assert rec["all-reduce"] == 8 * 16 * 4          # the tensor, once
    assert rec["reduce-scatter"] == 8 * 4 * 4       # its [8, 4] part
    assert rec["total"] == sum(rec[k] for k in partition.COLLECTIVE_KINDS)


def test_a_process_group_of_the_callers_is_refused():
    mesh = make_logical_mesh((2,), ("data",))
    with partition.fake_device_mesh(mesh):
        with pytest.raises(RuntimeError, match="already"):
            with partition.fake_device_mesh(mesh):
                pass


# ---------------------------------------------------------------------------
# (b) PeakMemory
# ---------------------------------------------------------------------------


def test_peak_memory_adds_allocations_and_takes_off_frees():
    a, b = _meta(MB), _meta(MB)                     # 4 MiB each, held

    def step(a, b):
        c = a + b                                   # + 4 MiB
        d = c.view(2, -1)                           # a view: nothing
        e = d * 2                                   # + 4 MiB: peak 16 MiB
        del c, d
        f = e.sum()                                 # + 4 B after c died
        del e
        g = a * 3                                   # 4 MiB again
        return f, g

    assert peak_memory(step, a, b) == 16 * MB


def test_peak_memory_sees_saved_tensors_and_remat():
    """Autograd keeps a layer's activations for the backward pass;
    ``checkpoint`` keeps only its input."""
    w = _meta(256, 256).requires_grad_(True)
    x = _meta(64, 256)

    def layer(h):
        return torch.tanh(h @ w) * 2

    def loss(remat):
        def run(x):
            h = x
            for _ in range(8):
                h = checkpoint(layer, h, use_reentrant=False) if remat \
                    else layer(h)
            (g,) = torch.autograd.grad(h.sum(), [w])
            return g
        return run

    plain, remat = peak_memory(loss(False), x), peak_memory(loss(True), x)
    act = 64 * 256 * 4
    assert plain >= 8 * 2 * act                     # h @ w and tanh a layer
    assert remat < plain


def test_the_kernels_allocations_on_meta():
    """Under ``kernel_allocations`` a ``meta`` attention holds what the
    kernel does (its output), not the plain version's [B, H, S, S]
    scores, counts no launch, and differentiates as on the card."""
    q = _meta(1, 2048, 8, 64, dtype=torch.bfloat16).requires_grad_(True)
    k = _meta(1, 2048, 2, 64, dtype=torch.bfloat16)
    before = flash_attention.launches
    plain = peak_memory(lambda q, k: flash_attention(q, k, k), q, k)
    with kernel_allocations():
        kern = peak_memory(lambda q, k: flash_attention(q, k, k), q, k)
        out = flash_attention(q, k, k)
        (g,) = torch.autograd.grad(out.float().sum(), [q])
    scores = 8 * 2048 * 2048 * 4
    assert plain >= scores > 10 * kern
    assert out.shape == q.shape and out.dtype == q.dtype
    assert g.shape == q.shape and g.dtype == q.dtype
    assert flash_attention.launches == before
    assert not torch.zeros(1, device=META).is_cuda


# ---------------------------------------------------------------------------
# (c) the mesh as DTensor sees it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,want", [
    ("decode_32k", [("pod", "data"), ("model",)]),
    ("long_500k", [("model",)]),
])
def test_axis_groups_merge_the_pod_and_data_batch(shape, want):
    """The batch's ``("pod", "data")`` is one dim; at batch 1 (the 4096
    slots of ``long_500k``'s window over ``model``) no spec uses the pod
    or data axes, and they are left out."""
    cfg = dryrun.get_config("tinyllama-1.1b")
    lo = dryrun.lower_decode(cfg, dryrun.get_input_shape(shape),
                             dryrun.make_production_mesh(multi_pod=True),
                             moe_impl="dense")
    assert partition.axis_groups(lo.mesh, lo.in_shardings) == want


def test_a_refused_layout_runs_replicated():
    """DTensor cannot unflatten a dim sharded 4 ways into [2, 8]: the op
    runs on its input replicated over the last axis, and counts."""
    mesh = make_logical_mesh((2, 4), ("data", "model"))
    x = _meta(8, 16)
    run = partition.run_partitioned(
        lambda x: x.reshape(8, 2, 8) * 2, (x,),
        (NamedSharding(mesh, P("data", "model")),), mesh)
    assert run.reason is None and run.refusals == {"aten.view.default": 1}
    assert run.collectives["counts"]["all-gather"] == 1
    assert run.collectives["all-gather"] == 4 * 16 * 4
    assert run.mesh == {"data": 2, "model": 4}
    assert run.peak_bytes >= 4 * 4 * 4 + 4 * 16 * 4


def _clear_propagation_cache(prop):
    for name in ("propagate_op_sharding", "_propagate_op_sharding"):
        fn = getattr(prop, name, None)
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()


def test_an_op_without_a_rule_runs_on_whole_copies():
    """Where DTensor has no rule for an op (torch 2.11 has none for
    ``flip``; removed here for the test), it runs on each device's whole
    copy: the gathers it takes are counted, the result is replicated."""
    prop = DTensor._op_dispatcher.sharding_propagator
    op = torch.ops.aten.flip.default
    tables = [t for t in vars(prop).values()
              if isinstance(t, dict) and op in t]
    saved = [(t, t.pop(op)) for t in tables]
    _clear_propagation_cache(prop)
    mesh = make_logical_mesh((2, 4), ("data", "model"))
    try:
        run = partition.run_partitioned(
            lambda x: torch.flip(x, [1]) * 2, (_meta(8, 16),),
            (NamedSharding(mesh, P("data", "model")),), mesh)
    finally:
        for t, v in saved:
            t[op] = v
        _clear_propagation_cache(prop)
    assert tables and run.reason is None
    assert run.refusals == {"aten.flip.default": 1}
    # gathered over model ([4, 16]), then over data ([8, 16])
    assert run.collectives["all-gather"] == (4 * 16 + 8 * 16) * 4


# ---------------------------------------------------------------------------
# (d) records on the production meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,mesh", [
    ("tinyllama-1.1b", "decode_32k", "single"),
    ("mamba2-130m", "long_500k", "multi"),
])
def test_records_carry_collectives_and_tracked_peaks(arch, shape, mesh):
    rec = dryrun.run_one(arch, shape, mesh, verbose=False)
    coll = rec["collectives"]
    assert rec["collectives_reason"] is None
    assert rec["collective_bytes_per_device"] == coll["total"] > 0
    assert coll["total"] == sum(coll[k] for k in partition.COLLECTIVE_KINDS)
    assert all(coll[k] > 0 for k in partition.COLLECTIVE_KINDS
               if coll["counts"][k])
    assert rec["collective_s"] == pytest.approx(
        coll["total"] / H100_SXM["ici_bandwidth"])
    terms = {"compute": rec["compute_s"], "memory": rec["memory_s"],
             "collective": rec["collective_s"]}
    assert rec["bottleneck"] == max(terms, key=terms.get)
    assert rec["peak_memory_per_device"] >= rec["peak_memory_lower_bound"]
    assert rec["partition_s"] >= 0 and rec["partition_mesh"]


def test_a_record_counted_only_says_so():
    """``partition=False`` (the chip's phase for most records) counts the
    step alone:
    the same FLOPs, the collectives and the tracked peak ``null`` with
    the reason."""
    full = dryrun.run_one("tinyllama-1.1b", "long_500k", "single",
                          verbose=False)
    rec = dryrun.run_one("tinyllama-1.1b", "long_500k", "single",
                         verbose=False, partition=False)
    assert rec["flops_per_device"] == full["flops_per_device"]
    assert rec["collective_bytes_per_device"] is None
    assert rec["peak_memory_per_device"] is None
    assert "not partitioned" in rec["collectives_reason"]
    assert rec["bottleneck"] in ("compute", "memory")


# ---------------------------------------------------------------------------
# (e) against the reference
# ---------------------------------------------------------------------------

FACTOR = 8.0     # PERF.md's dry-run table: every combination's factor
                 # lies within 8 either way (0.13 to 6.3)
CASES = [("tinyllama-1.1b", "train"), ("tinyllama-1.1b", "decode")]


@pytest.fixture(scope="module")
def reference():
    return vs_ref.reference_counts(CASES)


@pytest.mark.parametrize("arch,kind", CASES)
def test_collective_bytes_against_the_reference(reference, arch, kind):
    want = reference[f"{arch} {kind}"]
    run = vs_ref.port_run(arch, kind)
    got = run.collectives
    assert got is not None, run.reason
    assert want["total"] > 0 and got["total"] > 0
    factor = got["total"] / want["total"]
    assert 1 / FACTOR <= factor <= FACTOR, (factor, got, want)
    for side in (got, want):
        assert side["counts"]["all-gather"] > 0
        assert side["counts"]["all-reduce"] + side["counts"][
            "reduce-scatter"] > 0
    assert run.peak_bytes >= 0
