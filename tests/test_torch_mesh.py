"""The mesh tools (``repro_torch.launch.mesh``, ``launch.shapes``,
``sharding.specs``, ``sharding.ctx``) against the reference's, as pure
rules, on the production meshes and at published widths:

(a) ``param_structs`` (on ``meta``) equals the reference's
    ``jax.eval_shape`` tree for all ten architectures: names (the tree
    paths joined by ``/``), shapes and dtypes; ``batch_structs`` and
    ``cache_structs`` for all 40 (arch × shape) pairs, their specs too.
    The cache differs by design in two ways: the port has no
    ``cache_len`` scalar (C is the k/v cache's length) and keeps its
    positions (``pos``, ``k_pos``) in torch's int64 index type where the
    reference has int32;
(b) every leaf's ``param_spec`` equals the reference's on (16, 16) and
    (2, 16, 16) — the reference's rule called with ``test_sharding.py``'s
    ``FakeMesh``; ``opt_state_shardings``, ``cache_shardings`` (inside
    ``cache_structs``) and ``batch_structs`` against the reference's on a
    ``jax.sharding.AbstractMesh`` of the same shape; ``token_spec``,
    ``plane_spec`` and ``batch_axes``; the reference's own cases of
    ``test_sharding.py``;
(c) ``constrain`` is the identity outside and inside a context, and a
    ``forward`` under ``activation_sharding(_act_specs(...))`` is the
    unconstrained one bit for bit;
(d) the meshes: the production meshes' shapes, the host mesh on the CPU,
    and the H100 constants.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.launch import shapes as ref_shp
from repro.sharding import specs as ref_sh
from repro.train.optimizer import make_optimizer as ref_make_optimizer
from repro.configs.base import TrainConfig as RefTrainConfig

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import shapes as shp
from repro_torch.launch.dryrun import _act_specs
from repro_torch.launch.mesh import (H100_SXM, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.transformer import forward, init_model
from repro_torch.sharding import specs as sh
from repro_torch.sharding.ctx import activation_sharding, constrain
from repro_torch.train.optimizer import make_optimizer


class FakeMesh:
    """Just enough Mesh interface for the reference's rule functions
    (``tests/test_sharding.py``)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"single": dict(multi_pod=False), "multi": dict(multi_pod=True)}
REF_MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
              "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}
ABSTRACT = {"single": AbstractMesh((16, 16), ("data", "model")),
            "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
# the port's int64 index leaves where the reference has int32
INDEX_LEAVES = ("pos", "k_pos")


def _flat(tree):
    """A reference tree's leaves by ``/``-joined path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = leaf
    return out


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _same_structs(port, ref, index_leaves=()):
    assert set(port) == set(ref)
    for k, v in port.items():
        assert v.device.type == "meta", k
        assert tuple(v.shape) == tuple(ref[k].shape), k
        want = _dtype(ref[k])
        if k.split("/")[-1] in index_leaves:
            assert (_dtype(v), want) == ("int64", "int32"), k
        else:
            assert _dtype(v) == want, k


@pytest.fixture(scope="module")
def ref_params():
    return {a: _flat(ref_shp.param_structs(ref_get_config(a)))
            for a in ARCH_IDS}


@pytest.fixture(scope="module")
def port_params():
    return {a: shp.param_structs(get_config(a)) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# (a) structs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_structs_equal_the_reference(arch, ref_params, port_params):
    """Names, shapes, dtypes (bf16, the Mamba-2 scalars fp32) on
    ``meta``."""
    _same_structs(port_params[arch], ref_params[arch])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_structs_equal_the_reference(arch, mesh):
    """All four shapes: the structs, and each spec against the
    reference's ``NamedSharding.spec`` on an ``AbstractMesh``."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    port_mesh = make_production_mesh(**MESHES[mesh])
    for name, shape in INPUT_SHAPES.items():
        ref_shape = ref_shp.INPUT_SHAPES[name]
        assert shp.decode_window(cfg, shape) == ref_shp.decode_window(
            ref_cfg, ref_shape)
        b, b_spec = shp.batch_structs(cfg, shape, port_mesh)
        rb, rb_shard = ref_shp.batch_structs(ref_cfg, ref_shape,
                                             ABSTRACT[mesh])
        _same_structs(b, rb)
        assert b_spec == {k: tuple(s.spec) for k, s in rb_shard.items()}
        c, c_spec = shp.cache_structs(cfg, shape, port_mesh)
        rc, rc_shard = ref_shp.cache_structs(ref_cfg, ref_shape,
                                             ABSTRACT[mesh])
        rc, rc_spec = _flat(rc), {k: tuple(s.spec)
                                  for k, s in _flat(rc_shard).items()}
        assert rc.pop("cache_len").shape == () and rc_spec.pop(
            "cache_len") == ()
        _same_structs(c, rc, INDEX_LEAVES)
        assert c_spec == rc_spec, (name, mesh)


# ---------------------------------------------------------------------------
# (b) the partition rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_param_spec_equals_the_reference(mesh, ref_params,
                                               port_params):
    """Every leaf of every architecture, through ``params_shardings``,
    against the reference's ``param_spec`` on the ``FakeMesh`` (the rule
    its ``params_shardings`` applies to each leaf)."""
    port_mesh = make_production_mesh(**MESHES[mesh])
    sharded = 0
    for arch in ARCH_IDS:
        got = sh.params_shardings(port_params[arch], port_mesh)
        for k, leaf in ref_params[arch].items():
            want = ref_sh.param_spec(k.split("/"), leaf, REF_MESHES[mesh])
            assert got[k].spec == tuple(want), (arch, k)
            sharded += "model" in got[k].spec
    assert sharded > 100


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_opt_state_shardings_equal_the_reference(arch, mesh):
    """AdamW's moments (fp32 and bf16) mirror the params, the step
    replicates: against the reference's ``opt_state_shardings`` of its
    ``eval_shape``d state on an ``AbstractMesh``."""
    for moment in ("float32", "bfloat16"):
        p = shp.param_structs(get_config(arch))
        state = make_optimizer(TrainConfig(moment_dtype=moment))[0](p)
        port_mesh = make_production_mesh(**MESHES[mesh])
        got = sh.opt_state_shardings(state, sh.params_shardings(
            p, port_mesh), port_mesh)
        ref_init = ref_make_optimizer(RefTrainConfig(moment_dtype=moment))[0]
        rp = ref_shp.param_structs(ref_get_config(arch))
        rstate = jax.eval_shape(ref_init, rp)
        want = ref_sh.opt_state_shardings(rstate, None, ABSTRACT[mesh])
        assert got.step.spec == tuple(want.step.spec) == ()
        for part in ("m", "v"):
            w = {k: tuple(s.spec) for k, s in _flat(getattr(want,
                                                            part)).items()}
            assert {k: s.spec for k, s in getattr(got, part).items()} == w
            assert all(t.dtype == getattr(torch, moment)
                       for t in getattr(state, part).values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", [1, 2, 4, 33, 128, 256, 512])
def test_batch_token_and_plane_specs_equal_the_reference(mesh, batch):
    port_mesh = make_production_mesh(**MESHES[mesh])
    ref_mesh = REF_MESHES[mesh]
    assert sh.batch_axes(port_mesh, batch) == ref_sh.batch_axes(ref_mesh,
                                                                batch)
    for extra in (1, 2):
        assert sh.token_spec(port_mesh, batch, extra) == tuple(
            ref_sh.token_spec(ref_mesh, batch, extra))
    for seqlen in (batch, 4096, 524288):
        for used in ((), ("model",)):
            assert sh.seq_shard_axes(port_mesh, seqlen, used) == \
                ref_sh.seq_shard_axes(ref_mesh, seqlen, used)
    for p in (113744, 256 * batch, 16 * batch + 1):
        for shape in ((batch, p), (p,), (batch + 3, p, 2), (7,), ()):
            leaf = torch.empty(shape, device="meta")
            assert sh.plane_spec(leaf, port_mesh, p) == tuple(
                ref_sh.plane_spec(jax.ShapeDtypeStruct(shape, jnp.float32),
                                  ref_mesh, p))


def _leaf(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


MESH1 = make_production_mesh()


@pytest.mark.parametrize("names,shape,want", [
    (["embed"], (152064, 8192), ("model", None)),
    (["lm_head"], (8192, 152064), (None, "model")),
    (["blocks", "attn", "wq"], (32, 1536, 1536), (None, None, "model")),
    (["blocks", "attn", "wo"], (32, 1536, 1536), (None, "model", None)),
    (["groups", "pos1", "moe", "w_gate"], (9, 16, 8192, 24576),
     (None, "model", None, None)),
    (["blocks", "moe", "w_gate"], (32, 40, 1536, 512),
     (None, None, None, "model")),
    (["blocks", "moe", "router"], (32, 1536, 40), (None, None, None)),
    (["blocks", "ln1"], (32, 8192), (None, None)),
    (["something"], (100, 4096), (None, "model")),
    (["weird"], (7, 13), (None, None)),
])
def test_the_reference_rule_cases(names, shape, want):
    """``tests/test_sharding.py``'s cases on the port (vocab, fused
    projections, experts and their fallback, routers and norms
    replicated, the largest-divisible fallback)."""
    assert sh.param_spec(names, _leaf(*shape), MESH1) == want


def test_named_sharding_shard_shape():
    mesh = make_production_mesh(multi_pod=True)
    s = sh.NamedSharding(mesh, sh.P(("pod", "data"), None, "model"))
    assert s.shard_shape((256, 4096, 32000)) == (8, 4096, 2000)
    assert sh.P(("data",), None) == ("data", None)
    assert sh.NamedSharding(mesh, sh.P()).shard_shape(()) == ()


# ---------------------------------------------------------------------------
# (c) constrain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "seamless-m4t-medium",
                                  "phi-3-vision-4.2b"])
def test_constrain_is_the_identity(arch):
    x = torch.randn(2, 3, 4)
    assert constrain(x, "act") is x
    cfg = get_smoke_config(arch)
    mesh = make_production_mesh(multi_pod=True)
    p = init_model(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    seq = 8 + cfg.num_image_tokens
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, seq),
                                     generator=gen)}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(2, cfg.num_image_tokens,
                                            cfg.d_model, generator=gen)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = torch.randn(2, seq, cfg.d_model,
                                          generator=gen)
    plain, aux = forward(cfg, p, batch)
    with activation_sharding(_act_specs(mesh, cfg, 2)):
        assert constrain(x, "act") is x and constrain(x, "logits") is x
        got, got_aux = forward(cfg, p, batch)
    assert torch.equal(got, plain) and torch.equal(got_aux, aux)


# ---------------------------------------------------------------------------
# (d) meshes and constants
# ---------------------------------------------------------------------------


def test_meshes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.shape, one.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert (two.axis_names, two.shape, two.size) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}, 512)
    assert one.devices.shape == (16, 16)
    host = make_host_mesh(4, 4, device="cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices.flat[0] == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()


def test_h100_constants():
    """The reference's keys (``TPU_V5E``'s), with the H100 SXM's data
    sheet values at 700 W, and the fp32 and TF32 rates beside them."""
    from repro.launch.mesh import TPU_V5E
    assert set(TPU_V5E) <= set(H100_SXM)
    assert H100_SXM == {"peak_bf16_flops": 989e12, "hbm_bandwidth": 3.35e12,
                        "ici_bandwidth": 450e9, "hbm_bytes": 80e9,
                        "peak_tf32_flops": 495e12, "peak_fp32_flops": 67e12}
