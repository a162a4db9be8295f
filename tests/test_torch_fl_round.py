"""The paper's round over whole LM clients (``launch/fl_round.py``): the
reference's three tests of ``test_fl_round.py`` mirrored on the port, and
the port against ``repro.launch.fl_round.fl_round_step`` on the same
clients, in fp32 and in bf16 (divergence rtol 1e-5, labels equal,
``new_global`` within the reference's tolerance for the dtype).
``lower_fl_round``: its structs and stacked specs against the reference's
``stack_shard`` rule on the production meshes, its count, and on a CPU
host mesh ``compile("cpu")`` ≡ ``fl_round_step`` bit for bit, held to the
reference's round at the same bands."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch.fl_round import fl_round_step as ref_fl_round_step
from repro.models import init_model as ref_init_model
from repro.sharding import specs as ref_sh

from repro_torch.api import ExperimentSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.fl_round import (fl_round_step, lower_fl_round,
                                         lower_fl_round_from_spec)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.roofline.analysis import analyze_step
from repro_torch.models.transformer import init_model
from repro_torch.utils.trees import params_from_jax

ARCH = "tinyllama-1.1b"


def _setup(n=8, c=3, dtype=torch.float32):
    """The reference's ``_setup`` on the port: a global model, ``n``
    clients drawn from their own seeds and stacked, centroids on the
    ``lm_head`` features, sizes 1..n."""
    cfg = get_smoke_config(ARCH)
    g = init_model(cfg, torch.Generator().manual_seed(0), dtype=dtype)
    each = [init_model(cfg, torch.Generator().manual_seed(1 + i),
                       dtype=dtype) for i in range(n)]
    clients = {k: torch.stack([m[k] for m in each]) for k in g}
    feat = clients.get("lm_head", clients["embed"])
    cent = torch.randn((c, feat.reshape(n, -1).shape[1]),
                       generator=torch.Generator().manual_seed(2))
    sizes = torch.arange(1.0, n + 1.0)
    return cfg, g, clients, cent, sizes


def test_fl_round_selection_is_top_divergence_per_cluster():
    n, c = 8, 3
    cfg, g, clients, cent, sizes = _setup(n, c)
    new_g, div, labels = fl_round_step(clients, g, cent, sizes,
                                       num_clusters=c)
    div, labels = div.numpy(), labels.numpy()
    assert div.shape == (n,) and (div > 0).all()
    assert set(labels.tolist()) <= set(range(c))
    winners = set()
    for k in np.unique(labels):
        members = np.flatnonzero(labels == k)
        winners.add(members[np.argmax(div[members])])
    w = np.zeros(n)
    w[list(winners)] = sizes.numpy()[list(winners)]
    w = w / w.sum()
    lead = clients["embed"].reshape(n, -1).numpy()
    want = (w[:, None] * lead).sum(0)
    got = new_g["embed"].reshape(-1).numpy()
    np.testing.assert_allclose(got, want.astype(got.dtype), rtol=2e-2,
                               atol=1e-3)


def test_fl_round_feature_slice_consistency():
    """``feature_slice`` changes the clustering only, never the divergence
    or the fold's arithmetic."""
    cfg, g, clients, cent, sizes = _setup(8, 3)
    _, div_full, _ = fl_round_step(clients, g, cent, sizes, num_clusters=3)
    _, div_slice, labels = fl_round_step(clients, g, cent[:, :64], sizes,
                                         num_clusters=3, feature_slice=64)
    np.testing.assert_allclose(div_full.numpy(), div_slice.numpy(),
                               rtol=1e-6)
    assert labels.shape == (8,)


def test_identical_clients_zero_divergence():
    cfg, g, clients, cent, sizes = _setup(4, 2)
    same = {k: v.expand((4,) + v.shape) for k, v in g.items()}
    _, div, _ = fl_round_step(same, g, cent, sizes, num_clusters=2)
    assert float(div.max()) < 1e-3


def test_empty_cluster_and_ties():
    """An empty cluster selects nobody; a tie in divergence selects the
    first member, as ``argmax`` does; identical winners fold to
    themselves."""
    cfg, g, clients, cent, sizes = _setup(4, 3)
    same = {k: v.expand((4,) + v.shape).clone() for k, v in g.items()}
    feats = same["lm_head"].reshape(4, -1)
    far = torch.full_like(cent[:1], 1e3)
    cent = torch.cat([feats[:1].float(), far, far])   # clusters 1, 2 empty
    new_g, div, labels = fl_round_step(same, g, cent, sizes, num_clusters=3)
    assert labels.tolist() == [0, 0, 0, 0]
    assert float(div.max()) == 0.0
    for k, v in new_g.items():
        torch.testing.assert_close(v, g[k], rtol=1e-6, atol=1e-6)


def _reference_setup(n, c, jdt):
    """The reference's ``_setup`` in ``jdt``."""
    cfg = ref_smoke_config(ARCH)
    g = ref_init_model(cfg, jax.random.PRNGKey(0), dtype=jdt)
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    clients = jax.vmap(lambda k: ref_init_model(cfg, k, dtype=jdt))(keys)
    feat = clients.get("lm_head", clients["embed"])
    cent = jax.random.normal(jax.random.PRNGKey(2),
                             (c, feat.reshape(n, -1).shape[1]))
    return g, clients, cent, jnp.arange(1.0, n + 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fl_round_matches_the_reference(dtype):
    """The reference's ``_setup`` (its clients, centroids and sizes) through
    both packages: divergence within rtol 1e-5, labels equal, the new
    global model in the leaves' dtype within the reference's tolerance for
    it (1e-5 in fp32; ``test_kernels.py``'s bf16 2e-2)."""
    n, c = 8, 3
    g, clients, cent, sizes = _reference_setup(n, c, getattr(jnp, dtype))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(
        rtol=2e-2, atol=2e-2)
    for fs in (0, 64):
        cen = cent[:, :fs] if fs else cent
        want_g, want_div, want_lab = ref_fl_round_step(
            clients, g, cen, sizes, num_clusters=c, feature_slice=fs)
        port = params_from_jax(jax.tree_util.tree_map(np.asarray, clients))
        port_g = params_from_jax(jax.tree_util.tree_map(np.asarray, g))
        got_g, div, labels = fl_round_step(
            port, port_g, torch.tensor(np.asarray(cen)),
            torch.tensor(np.asarray(sizes)), num_clusters=c,
            feature_slice=fs)
        assert div.dtype == torch.float32
        np.testing.assert_allclose(div.numpy(), np.asarray(want_div),
                                   rtol=1e-5)
        assert labels.tolist() == np.asarray(want_lab).tolist()
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_g))
        assert set(got_g) == set(want)
        for k, v in got_g.items():
            assert v.dtype == want[k].dtype == port_g[k].dtype, k
            np.testing.assert_allclose(v.float().numpy(),
                                       want[k].float().numpy(), **tol)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("num_clients", [1, 33, 128, 512])
def test_lower_fl_round_specs_are_the_reference_stack_shard(multi,
                                                           num_clients):
    """Published-width tinyllama clients on a production mesh: each
    client leaf is the global leaf's ``meta`` struct with the client axis
    in front, its spec the reference's ``stack_shard`` of the leaf's
    ``param_spec`` (``batch_axes`` of the client count, then the leaf's
    own); centroids ``[c, d·V]`` and sizes replicated."""
    mesh = make_production_mesh(multi_pod=multi)
    ref_mesh = type("FakeMesh", (), dict(shape=dict(mesh.shape),
                                         axis_names=mesh.axis_names))()
    lo = lower_fl_round(get_config(ARCH), mesh, num_clients=num_clients,
                        num_clusters=4)
    clients, glob, cent, sizes = lo.args
    c_shard, p_shard, rep, _ = lo.in_shardings
    ba = ref_sh.batch_axes(ref_mesh, num_clients)
    for k, leaf in glob.items():
        assert clients[k].device.type == "meta"
        assert clients[k].dtype == leaf.dtype == torch.bfloat16
        assert tuple(clients[k].shape) == (num_clients,) + tuple(leaf.shape)
        own = ref_sh.param_spec(k.split("/"),
                                jax.ShapeDtypeStruct(tuple(leaf.shape),
                                                     jnp.bfloat16), ref_mesh)
        want = jax.sharding.PartitionSpec(ba if ba else None, *own)
        assert c_shard[k].spec == tuple(want), k
        assert p_shard[k].spec == tuple(own), k
    cfg = get_config(ARCH)
    assert tuple(cent.shape) == (4, cfg.d_model * cfg.vocab_size)
    assert rep.spec == () and tuple(sizes.shape) == (num_clients,)
    with pytest.raises(NotImplementedError, match="SPMD"):
        lo.compile("cuda")


def test_lower_fl_round_counts_the_round():
    """The lowered round's count is the round's, run on its structs: the
    K-means products (2·N·c·F) and more, every client byte read."""
    cfg = get_config(ARCH)
    lo = lower_fl_round(cfg, make_host_mesh(device="cpu"), num_clients=16,
                        num_clusters=4, feature_slice=4096)
    cost = lo.cost_analysis()
    again = analyze_step(lo.fn, *lo.args)
    assert cost == {"flops": again.flops, "bytes accessed": again.bytes}
    assert cost["flops"] == 2 * 16 * 4 * 4096
    client_bytes = sum(v.numel() * v.element_size()
                       for v in lo.args[0].values())
    assert cost["bytes accessed"] > 2 * client_bytes
    assert lo.memory_per_device() > client_bytes


def test_lower_fl_round_compiles_to_the_round():
    """On the CPU's one-device host mesh: ``compile("cpu")`` is
    ``fl_round_step`` (bit for bit on the port's bf16 clients) and is held
    to the reference's round on its bf16 clients at the bf16 bands."""
    n, c = 8, 3
    lo = lower_fl_round(get_smoke_config(ARCH), make_host_mesh(
        device="cpu"), num_clients=n, num_clusters=c)
    step = lo.compile("cpu")
    with pytest.raises(ValueError, match="mesh's device"):
        lo.compile("meta")
    _, g, clients, cent, sizes = _setup(n, c, torch.bfloat16)
    got = step(clients, g, cent, sizes)
    want = fl_round_step(clients, g, cent, sizes, num_clusters=c)
    assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    rg, rclients, rcent, rsizes = _reference_setup(n, c, jnp.bfloat16)
    want_g, want_div, want_lab = ref_fl_round_step(
        rclients, rg, rcent, rsizes, num_clusters=c)
    got_g, div, labels = step(
        params_from_jax(jax.tree_util.tree_map(np.asarray, rclients)),
        params_from_jax(jax.tree_util.tree_map(np.asarray, rg)),
        torch.tensor(np.asarray(rcent)), torch.tensor(np.asarray(rsizes)))
    np.testing.assert_allclose(div.numpy(), np.asarray(want_div), rtol=1e-5)
    assert labels.tolist() == np.asarray(want_lab).tolist()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_g))
    for k, v in got_g.items():
        np.testing.assert_allclose(v.float().numpy(),
                                   want[k].float().numpy(), rtol=2e-2,
                                   atol=2e-2)


def test_lower_fl_round_from_spec():
    spec = ExperimentSpec(model="mamba2-130m", clients=6, num_clusters=2)
    lo = lower_fl_round_from_spec(spec, make_production_mesh(),
                                  feature_slice=64)
    assert next(iter(lo.args[0].values())).shape[0] == 6
    assert tuple(lo.args[2].shape) == (2, 64)
    with pytest.raises(ValueError, match="arch id"):
        lower_fl_round_from_spec(ExperimentSpec(), make_production_mesh())
