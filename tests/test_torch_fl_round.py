"""The paper's round over whole LM clients (``launch/fl_round.py``): the
reference's three tests of ``test_fl_round.py`` mirrored on the port, and
the port against ``repro.launch.fl_round.fl_round_step`` on the same
clients, in fp32 and in bf16 (divergence rtol 1e-5, labels equal,
``new_global`` within the reference's tolerance for the dtype)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch.fl_round import fl_round_step as ref_fl_round_step
from repro.models import init_model as ref_init_model

from repro_torch.configs import get_smoke_config
from repro_torch.launch.fl_round import fl_round_step
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fl_round_matches_the_reference(dtype):
    """The reference's ``_setup`` (its clients, centroids and sizes) through
    both packages: divergence within rtol 1e-5, labels equal, the new
    global model in the leaves' dtype within the reference's tolerance for
    it (1e-5 in fp32; ``test_kernels.py``'s bf16 2e-2)."""
    n, c = 8, 3
    jdt = getattr(jnp, dtype)
    cfg = ref_smoke_config(ARCH)
    g = ref_init_model(cfg, jax.random.PRNGKey(0), dtype=jdt)
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    clients = jax.vmap(lambda k: ref_init_model(cfg, k, dtype=jdt))(keys)
    feat = clients.get("lm_head", clients["embed"])
    cent = jax.random.normal(jax.random.PRNGKey(2),
                             (c, feat.reshape(n, -1).shape[1]))
    sizes = jnp.arange(1.0, n + 1.0)
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
