"""The roofline (``repro_torch.roofline.analysis``) against the reference's
``tests/test_roofline.py`` and its module:

(a) ``_shape_bytes`` and ``collective_bytes`` equal the reference's on its
    canned HLO and on the HLO text of a function the reference compiles
    (a ``psum`` and an ``all_gather`` under ``pmap``);
(b) ``model_flops`` equals the reference's for all 40 (arch × shape)
    pairs, forward and with the backward;
(c) ``RooflineReport`` divides by the H100's peaks (``compute_s =
    flops/989e12``, ``memory_s = bytes/3.35e12``, ``collective_s =
    bytes/450e9``), and leaves a ``None`` collective term out;
(d) ``analyze_step``: a plain matmul counts exactly 2·M·N·K FLOPs and the
    bytes of its operands and result; a view moves no bytes; a 10-step
    loop counts 10 bodies — the opposite of the reference's
    ``test_cost_analysis_undercounts_scan_loops``, where XLA counts a scan
    body once: eager execution runs every step.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import INPUT_SHAPES as REF_INPUT_SHAPES
from repro.roofline import analysis as ref_roof

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.roofline.analysis import (RooflineReport, _shape_bytes,
                                           analyze_step, collective_bytes,
                                           model_flops)

CANNED = """
  %ag.1 = bf16[8,256]{1,0} all-gather(bf16[8,16]{1,0} %p0), replica_groups={}
  %ar = f32[128]{0} all-reduce(f32[128]{0} %x), to_apply=%add
  %rs = f32[16,8]{1,0} reduce-scatter(f32[16,128]{1,0} %y), dimensions={1}
  %a2a = bf16[4,32]{1,0} all-to-all(bf16[4,32]{1,0} %z), dimensions={0}
  %cp = u32[2]{0} collective-permute(u32[2]{0} %w), source_target_pairs={{0,1}}
  %other = f32[10]{0} add(f32[10]{0} %a, f32[10]{0} %b)
"""
ASYNC = """
  %ags = (bf16[8,16]{1,0}, bf16[8,256]{1,0}) all-gather-start(bf16[8,16]{1,0} %p0)
  %agd = bf16[8,256]{1,0} all-gather-done((bf16[8,16]{1,0}, bf16[8,256]{1,0}) %ags)
"""


@pytest.mark.parametrize("dtype,dims", [
    ("bf16", "8,128"), ("f32", "4,4,4"), ("pred", "10"), ("f32", ""),
    ("c128", "3,5"), ("s64", "7"), ("weird", "2,2")])
def test_shape_bytes(dtype, dims):
    assert _shape_bytes(dtype, dims) == ref_roof._shape_bytes(dtype, dims)
    assert _shape_bytes("bf16", "8,128") == 8 * 128 * 2


def test_collective_parser_on_canned_hlo():
    out = collective_bytes(CANNED)
    assert out == ref_roof.collective_bytes(CANNED)
    assert out["all-gather"] == 8 * 256 * 2
    assert out["collective-permute"] == 2 * 4
    assert out["total"] == sum(out[k] for k in (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"))
    out = collective_bytes(ASYNC)
    assert out == ref_roof.collective_bytes(ASYNC)
    assert out["counts"]["all-gather"] == 1


def test_collective_parser_on_a_reference_compiled_function():
    f = jax.pmap(lambda x: jax.lax.psum(x, "i")
                 + jax.lax.all_gather(x, "i").sum(0), axis_name="i")
    text = f.lower(jnp.ones((1, 8, 128))).compile().as_text()
    out = collective_bytes(text)
    assert out == ref_roof.collective_bytes(text)
    assert out["counts"]["all-reduce"] == out["counts"]["all-gather"] == 1
    assert out["all-reduce"] == 8 * 128 * 4


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equals_the_reference(arch, shape):
    for backward in (False, True):
        assert model_flops(get_config(arch), INPUT_SHAPES[shape],
                           include_backward=backward) == ref_roof.model_flops(
            ref_get_config(arch), REF_INPUT_SHAPES[shape],
            include_backward=backward)


def _report(**kw):
    base = dict(arch="x", shape="train_4k", mesh="single", chips=256,
                flops_per_device=989e12, bytes_per_device=3.35e12 * 2,
                collective_bytes_per_device=450e9 * 0.5,
                model_flops_global=989e12 * 256)
    return RooflineReport(**{**base, **kw})


def test_roofline_report_divides_by_the_h100():
    r = _report()
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.bottleneck == "memory" and r.step_time_s == pytest.approx(2.0)
    assert r.useful_ratio == pytest.approx(1.0)
    r = _report(collective_bytes_per_device=450e9 * 3)
    assert r.bottleneck == "collective" and r.step_time_s == pytest.approx(3)
    ref = ref_roof.RooflineReport(
        arch="x", shape="train_4k", mesh="single", chips=256,
        flops_per_device=1.0, bytes_per_device=1.0,
        collective_bytes_per_device=1.0, model_flops_global=1.0)
    assert set(r.to_dict()) == set(ref.to_dict())


def test_a_missing_collective_term_is_left_out():
    """No collective bytes (the port has no partitioner): the term is
    ``None``, and the bottleneck and step time come from the other two
    even where a zero would have won."""
    r = _report(collective_bytes_per_device=None, flops_per_device=0.0,
                bytes_per_device=0.0)
    assert r.collective_s is None
    assert r.bottleneck == "compute" and r.step_time_s == 0.0
    r = _report(collective_bytes_per_device=None, flops_per_device=989e12 * 3)
    assert r.bottleneck == "compute" and r.step_time_s == pytest.approx(3.0)
    assert r.to_dict()["collective_s"] is None


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_matmul_counts_exactly(device):
    M, N, K = 64, 32, 128
    a = torch.ones((M, K), device=device)
    b = torch.ones((K, N), device=device)
    c = analyze_step(lambda a, b: a @ b, a, b)
    assert c.flops == 2 * M * N * K
    assert c.bytes == 4 * (M * K + K * N + M * N)
    assert tuple(c.outputs.shape) == (M, N)
    view = analyze_step(lambda a: a.reshape(K, M).t(), a)
    assert view.flops == 0 and view.bytes == 0


def test_a_loop_counts_every_body():
    """Ten steps of ``c @ w`` count ten bodies (forward), and nineteen
    more with their backward: each step's weight gradient, and the
    gradient through every step but the first (``x`` needs none)."""
    M = 64
    ws = torch.empty((10, M, M), device="meta", requires_grad=True)
    x = torch.empty((8, M), device="meta")

    def loop(ws, x):
        for w in ws:
            x = x @ w
        return x

    body = 2 * 8 * M * M
    assert analyze_step(loop, ws, x).flops == 10 * body
    c = analyze_step(lambda ws, x: torch.autograd.grad(
        loop(ws, x).sum(), ws), ws, x)
    assert c.flops == 29 * body
