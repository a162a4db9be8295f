"""The reference's last public names in the port, each held to the
reference on the CPU:

- ``core.wireless.DEFAULT_CYCLES_PER_SAMPLE``, ``DEFAULT_SAMPLES`` and
  ``models.cnn.PAPER_LAYER_NAMES``: equal;
- ``core.baselines.arr_ith``: device ``i``'s fleet arrays, equal;
- ``core.engine.model_eval``: accuracy equal, per-class accuracy within
  1e-6, on a CNN drawn from a seed;
- ``utils.trees.tree_weighted_mean_stacked``: rtol 1e-6;
- the tree forms of ``compress_int8``, ``compress_topk`` and
  ``apply_compression`` on a CNN tree: top-k bit for bit; int8 bit for
  bit but where a value a few ulps off the reference's rounds to the
  neighbouring int8 step (at most one step, on at most one entry in 10^4);
  the block forms, which the round body calls, give the bits they gave
  before the tree forms (the earlier code kept here verbatim);
- ``kernels.ops.kernel_dispatch``: the device rule, the reference's answer
  off-TPU on a CPU tensor;
- ``roofline.analysis.analyze_compiled``: a product's FLOPs and the
  reference's report keys, no collectives on one device.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNN_CONFIGS as REF_CNN
from repro.core import baselines as ref_baselines
from repro.core import compression as ref_compression
from repro.core import engine as ref_engine
from repro.core import wireless as ref_wireless
from repro.kernels import ops as ref_ops
from repro.models import cnn as ref_cnn
from repro.roofline import analysis as ref_analysis
from repro.utils import trees as ref_trees

from repro_torch.configs.paper_cnn import CNN_CONFIGS
from repro_torch.core import baselines, compression, engine, wireless
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import cnn
from repro_torch.roofline import analysis
from repro_torch.utils import trees


def _cnn_tree(seed, name="mnist"):
    """A CNN's parameters drawn from ``seed`` (numpy), biases non-zero."""
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 0.1, s).astype(np.float32)
            for k, s in cnn.cnn_param_shapes(CNN_CONFIGS[name]).items()}


def _port(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _ref(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_constants_equal_the_reference():
    assert wireless.DEFAULT_CYCLES_PER_SAMPLE == \
        ref_wireless.DEFAULT_CYCLES_PER_SAMPLE
    assert wireless.DEFAULT_SAMPLES == ref_wireless.DEFAULT_SAMPLES
    assert cnn.PAPER_LAYER_NAMES == ref_cnn.PAPER_LAYER_NAMES
    assert cnn.PAPER_LAYER_NAMES == tuple(
        cnn.cnn_param_shapes(CNN_CONFIGS["mnist"]))


@pytest.mark.parametrize("i", [0, 3, 9])
def test_arr_ith_equals_the_reference(i):
    fleet = wireless.sample_fleet(10, seed=2)
    got = baselines.arr_ith(wireless.fleet_arrays(fleet), i)
    want = ref_baselines.arr_ith(
        ref_wireless.fleet_arrays(ref_wireless.sample_fleet(10, seed=2)), i)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("name", ["mnist", "fashion"])
def test_model_eval_equals_the_reference(name):
    params = _cnn_tree(5, name)
    cfg = CNN_CONFIGS[name]
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (64, *cfg.input_hw,
                          cfg.input_channels)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, 64).astype(np.int32)
    acc, per_class = engine.model_eval(cfg)(_port(params), torch.tensor(x),
                                           torch.tensor(y))
    r_acc, r_per_class = ref_engine.model_eval(REF_CNN[name])(
        _ref(params), jnp.asarray(x), jnp.asarray(y))
    assert float(acc) == float(r_acc)
    np.testing.assert_allclose(per_class.numpy(), np.asarray(r_per_class),
                               rtol=0, atol=1e-6)
    assert engine.model_eval(cfg) is engine.model_eval(cfg)


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_weighted_mean_stacked_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    stacked = {"w": rng.normal(size=(5, 4, 3)).astype(np.float32),
               "b": rng.normal(size=(5, 7)).astype(np.float32)}
    w = rng.uniform(0.5, 3.0, 5)
    got = trees.tree_weighted_mean_stacked(_port(stacked), w)
    want = ref_trees.tree_weighted_mean_stacked(_ref(stacked), w)
    for k in stacked:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    listed = trees.tree_weighted_mean(
        [{k: torch.tensor(v[i]) for k, v in stacked.items()}
         for i in range(5)], w)
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), listed[k].numpy(),
                                   rtol=1e-6)


def test_tree_weighted_mean_stacked_is_idempotent_and_keeps_dtype():
    t = torch.full((3, 3), 2.5)
    agg = trees.tree_weighted_mean_stacked(
        {"w": torch.stack([t] * 4), "h": torch.stack([t.bfloat16()] * 4)},
        np.array([1, 7, 3, 2.0]))
    np.testing.assert_allclose(agg["w"].numpy(), 2.5, rtol=1e-6)
    assert agg["h"].dtype == torch.bfloat16
    assert torch.all(agg["h"] == 2.5)


# ---------------------------------------------------------------------------
# the compressors' tree forms
# ---------------------------------------------------------------------------


def _int8_within_one_step(got, want, leaf):
    """Bits equal but where a value rounds to the neighbouring int8 step:
    at most one step apart, on at most one entry in 10^4."""
    scale = max(float(np.max(np.abs(leaf))), 1e-12) / 127.0
    diff = np.abs(got - want)
    assert np.all(diff <= scale * 1.0001), float(diff.max() / scale)
    assert np.count_nonzero(diff) <= max(1, got.size // 10_000)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_tree_equals_the_reference_on_a_cnn(seed):
    tree = _cnn_tree(seed)
    got = compression.compress_int8(_port(tree))
    want = ref_compression.compress_int8(_ref(tree))
    assert set(got) == set(cnn.PAPER_LAYER_NAMES)
    for k in tree:
        assert got[k].dtype == torch.float32
        _int8_within_one_step(got[k].numpy(), np.asarray(want[k]), tree[k])


@pytest.mark.parametrize("fraction", [0.01, 0.05, 0.4])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_tree_equals_the_reference_on_a_cnn(fraction, seed):
    tree = _cnn_tree(seed)
    got = compression.compress_topk(_port(tree), fraction)
    want = ref_compression.compress_topk(_ref(tree), fraction)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        kept = math.ceil(fraction * tree[k].size)
        assert np.count_nonzero(got[k].numpy()) == max(kept, 1)


@pytest.mark.parametrize("scheme", [None, "none", "int8", "topk:0.05"])
def test_apply_compression_equals_the_reference(scheme):
    tree = _cnn_tree(3)
    tree_int = dict(tree, steps=np.arange(4, dtype=np.int32))
    got = compression.apply_compression(_port(tree_int), scheme)
    want = ref_compression.apply_compression(_ref(tree_int), scheme)
    assert torch.equal(got["steps"], torch.arange(4, dtype=torch.int32))
    for k in tree:
        if scheme == "int8":
            _int8_within_one_step(got[k].numpy(), np.asarray(want[k]),
                                  tree[k])
        else:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    with pytest.raises(ValueError):
        compression.apply_compression(_port(tree), "fp4")
    with pytest.raises(ValueError):
        ref_compression.apply_compression(_ref(tree), "fp4")


def test_the_reference_cases_hold_on_the_tree_forms():
    """``tests/test_beyond_paper.py``'s two compressor cases."""
    x = {"w": torch.randn(100, 50, generator=torch.Generator().manual_seed(0))}
    y = compression.compress_int8(x)
    scale = float(torch.max(torch.abs(x["w"]))) / 127.0
    assert float(torch.max(torch.abs(x["w"] - y["w"]))) <= scale * 0.5 + 1e-6
    got = compression.compress_topk(
        {"w": torch.tensor([1.0, -5.0, 0.1, 3.0, -0.2])}, 0.4)["w"].numpy()
    assert got[1] == -5.0 and got[3] == 3.0
    assert got[0] == 0.0 and got[2] == 0.0 and got[4] == 0.0


def _block_int8_before(block, lanes=False):
    """``compress_int8``'s block form as it stood before the tree forms."""
    a = (block.to(torch.float32).reshape(block.shape[0], -1) if lanes
         else block.to(torch.float32).reshape(1, -1))
    amax = torch.amax(torch.abs(a), dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return (q.to(torch.float32) * scale).reshape(block.shape)


def _block_topk_before(block, fraction, lanes=False):
    """``compress_topk``'s block form as it stood before the tree forms."""
    a = (block.to(torch.float32).reshape(block.shape[0], -1) if lanes
         else block.to(torch.float32).reshape(1, -1))
    k = max(int(math.ceil(fraction * a.shape[1])), 1)
    mag = torch.abs(a)
    thresh = torch.topk(mag, k, dim=1).values[:, -1:]
    kept = torch.where(mag >= thresh, a, torch.zeros_like(a))
    return kept.reshape(block.shape).to(block.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes", [False, True])
def test_block_callers_get_the_same_bits(dtype, lanes):
    """The round body's calls (a ``[S_pad, size]`` block, or ``[B, S_pad,
    size]`` lanes) give the bits they gave before the tree forms, and the
    registered compressors' ``apply_flat`` is those block calls."""
    from repro_torch.api.registry import COMPRESSORS
    from repro_torch.core.engine import model_flat_spec
    gen = torch.Generator().manual_seed(11)
    shape = (3, 6, 500) if lanes else (6, 500)
    block = (torch.randn(shape, generator=gen) * 0.01).to(dtype)
    assert torch.equal(compression.compress_int8(block, lanes),
                       _block_int8_before(block, lanes))
    for f in (0.01, 0.3):
        assert torch.equal(compression.compress_topk(block, f, lanes),
                           _block_topk_before(block, f, lanes))
    spec = model_flat_spec(CNN_CONFIGS["fashion"])
    rows = torch.randn(6, spec.total, generator=gen) * 0.1
    g = torch.randn(spec.total, generator=gen) * 0.1
    got = COMPRESSORS.resolve("int8").apply_flat(rows, g, spec)
    want = g[None, :] + torch.cat(
        [_block_int8_before((rows - g[None, :])[:, spec.columns(n)])
         for n in spec.names], dim=-1)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# kernel_dispatch and analyze_compiled
# ---------------------------------------------------------------------------


class _CudaLike:
    is_cuda = True


def test_kernel_dispatch_is_the_device_rule():
    """A CPU (or ``meta``) tensor takes the plain path, as the reference
    does off-TPU with ``use_pallas=None``; a CUDA tensor the kernel."""
    assert ops.kernel_dispatch(torch.zeros(3)) is False
    assert ops.kernel_dispatch(torch.zeros(3, device="meta")) is False
    assert ref_ops.kernel_dispatch(None) is (jax.default_backend() == "tpu")
    assert ops.kernel_dispatch(torch.zeros(3)) is ref_ops.kernel_dispatch(
        None)
    assert ops.kernel_dispatch(_CudaLike()) is True


def test_analyze_compiled_reads_a_lowered_product():
    """The FLOPs of ``a @ b`` (2·M·N·K) in both packages' reports, the
    same report keys, no collective on one device, and the tracked peak
    at least the arguments and the result."""
    from repro_torch.configs import get_input_shape, get_smoke_config
    from repro_torch.sharding.specs import NamedSharding, P
    M, N, K = 64, 32, 128
    mesh = make_host_mesh(device="cpu")
    rep = NamedSharding(mesh, P())
    lowered = analysis.Lowered(
        lambda a, b: a @ b, (torch.empty(M, K, device="meta"),
                             torch.empty(K, N, device="meta")),
        (rep, rep), rep, mesh=mesh)
    cfg = get_smoke_config("tinyllama-1.1b")
    shape = get_input_shape("decode_32k")
    report = analysis.analyze_compiled(
        lowered, arch="x", shape=shape, mesh_name="host", chips=1, cfg=cfg,
        include_backward=False)
    assert report.flops_per_device == 2 * M * N * K
    assert report.collective_bytes_per_device == 0.0
    assert report.collectives["counts"]["all-gather"] == 0
    assert report.peak_memory_per_device >= lowered.memory_per_device() \
        == 4 * (M * K + K * N + M * N)
    compiled = jax.jit(lambda a, b: a @ b).lower(
        jax.ShapeDtypeStruct((M, K), jnp.float32),
        jax.ShapeDtypeStruct((K, N), jnp.float32)).compile()
    from repro.configs import get_input_shape as ref_shape
    from repro.configs import get_smoke_config as ref_smoke
    ref = ref_analysis.analyze_compiled(
        compiled, arch="x", shape=ref_shape("decode_32k"), mesh_name="host",
        chips=1, cfg=ref_smoke("tinyllama-1.1b"), include_backward=False)
    assert ref.flops_per_device == pytest.approx(report.flops_per_device,
                                                 rel=0.01)
    assert ref.collective_bytes_per_device == 0.0
    assert set(ref.to_dict()) == set(report.to_dict())
    assert report.model_flops_global == ref.model_flops_global
