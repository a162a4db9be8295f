"""The port's federated LM (LoRA adapters over tinyllama / mamba2) against
the reference's, on the CPU.

Layers, the forward pass, the loss and its adapter gradients are held
against ``repro.models`` with the reference's base carried over by
``params_from_jax`` (forward at atol 2e-5, the reference's own kernel-vs-
jnp bound, ``test_lm.py``; gradients at 1e-4). The data, the adapter's
flat layout and the upload pricing must be equal. The slice test runs the
reference's ``TINY_LM`` host loop (initial round + 2 rounds) against the
port with a draws object that replays the reference's adapter init, base,
batch indices and k-means++ choices: equal initial rows, cluster labels and
selected sets; T_k/E_k within the SAO band (rtol 2e-3); global row and
plane within atol 1e-4; accuracy within one test token.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as RefSpec
from repro.api import build_experiment as ref_build_experiment
from repro.configs import get_config as ref_get_config
from repro.core.clustering import resolve_feature_columns as ref_resolve
from repro.core.engine import model_flat_spec as ref_model_flat_spec
from repro.data.lm_data import make_lm_dataset as ref_make_lm_dataset
from repro.models import layers as RL
from repro.models import lm as ref_lm
from repro.models.registry import workload_config as ref_workload_config
from repro.models.transformer import forward as ref_forward
from repro.utils.trees import tree_flatten_vector

from repro_torch.api import ExperimentSpec, build_experiment
from repro_torch.configs import get_config
from repro_torch.core.clustering import resolve_feature_columns
from repro_torch.core.engine import model_flat_spec
from repro_torch.data.lm_data import make_lm_dataset
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.registry import (model_def_for, workload_config,
                                         workload_names)
from repro_torch.models.transformer import forward
from repro_torch.utils.trees import params_from_jax

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("tinyllama", "mamba2-130m")
TINY_LM = dict(clients=6, train_samples=48, test_samples=16,
               samples_per_client=8, devices_per_round=2, num_clusters=2,
               local_iters=2, batch_size=4, rounds=2, learning_rate=0.1,
               seed=0)


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    """(port LMConfig, reference LMConfig, port base, reference base)."""
    ref_cfg = ref_workload_config(arch)
    ref_base = ref_lm.base_params(ref_cfg)
    base = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_base))
    return workload_config(arch), ref_cfg, base, ref_base


def _tokens(seed, cfg, b, s):
    return np.random.default_rng(seed).integers(
        0, cfg.model.vocab_size, (b, s)).astype(np.int32)


def _layer0(tree):
    return jax.tree_util.tree_map(lambda x: x[0], tree)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# layers at the smoke widths
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope_match():
    x, w = _normal(0, 2, 8, 128), _normal(1, 128)
    np.testing.assert_allclose(
        L.rmsnorm(torch.tensor(x), torch.tensor(w)).numpy(),
        np.asarray(RL.rmsnorm(x, w)), **FWD_TOL)
    h = _normal(2, 2, 8, 4, 16)
    for pos in (np.arange(8), np.tile(np.arange(3, 11), (2, 1))):
        np.testing.assert_allclose(
            L.apply_rope(torch.tensor(h), torch.tensor(pos), 1e4).numpy(),
            np.asarray(RL.apply_rope(h, jnp.asarray(pos), 1e4)), **FWD_TOL)


def test_attention_qkv_and_mlp_match():
    cfg, ref_cfg, base, ref_base = _cfgs("tinyllama")
    x = _normal(3, 2, 8, cfg.model.d_model)
    port = {k: v[0] for k, v in L.sub(base, "blocks").items()}
    for got, want in zip(
            L.attention_qkv(L.sub(port, "attn"), torch.tensor(x), cfg.model),
            RL.attention_qkv(_layer0(ref_base["blocks"]["attn"]), x,
                             ref_cfg.model)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(
        L.mlp_apply(L.sub(port, "mlp"), torch.tensor(x)).numpy(),
        np.asarray(RL.mlp_apply(_layer0(ref_base["blocks"]["mlp"]), x)),
        **FWD_TOL)


def test_mamba2_apply_matches():
    cfg, ref_cfg, base, ref_base = _cfgs("mamba2-130m")
    x = _normal(4, 2, 40, cfg.model.d_model)     # two SSD chunks, ragged
    port = {k: v[0] for k, v in L.sub(base, "blocks/mamba").items()}
    np.testing.assert_allclose(
        L.mamba2_apply(port, torch.tensor(x), cfg.model).numpy(),
        np.asarray(jax.jit(RL.mamba2_apply, static_argnums=2)(
            _layer0(ref_base["blocks"]["mamba"]), x, ref_cfg.model)),
        **FWD_TOL)


def test_causal_conv_matches():
    x, w, b = _normal(5, 2, 9, 6), _normal(6, 4, 6), _normal(7, 6)
    np.testing.assert_allclose(
        L.causal_conv1d(*(torch.tensor(t) for t in (x, w, b))).numpy(),
        np.asarray(RL.causal_conv1d(x, w, b)), **FWD_TOL)


# ---------------------------------------------------------------------------
# the forward pass, the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch):
    cfg, ref_cfg, base, ref_base = _cfgs(arch)
    toks = _tokens(8, cfg, 2, cfg.seq_len)
    got, aux = forward(cfg.model, base, {"tokens": torch.tensor(toks)})
    want, want_aux = ref_forward(ref_cfg.model, ref_base, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_adapter_gradients_match(arch):
    cfg, ref_cfg, base, _ = _cfgs(arch)
    adapter = ref_lm.init_adapter(ref_cfg, jax.random.PRNGKey(3))
    # nonzero B factors, so the gradients of the A factors are not zero
    adapter = jax.tree_util.tree_map(
        lambda l: l + 0.05 * jax.random.normal(jax.random.PRNGKey(4),
                                               l.shape), adapter)
    toks = _tokens(9, cfg, 3, cfg.seq_len + 1)
    batch = {"images": jnp.asarray(toks), "labels": jnp.zeros(3, jnp.int32)}
    loss_r, grads_r = jax.jit(jax.value_and_grad(ref_lm.lm_loss),
                              static_argnums=2)(adapter, batch, ref_cfg)
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_jax(adapter).items()}
    loss = lm.lm_loss(leaves, torch.tensor(toks), cfg, base)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_r), **FWD_TOL)
    want = params_from_jax(grads_r)
    for (name, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD_TOL)
        assert float(g.abs().sum()) > 0.0


def test_fresh_adapter_is_a_noop_on_the_base():
    cfg, _, base, _ = _cfgs("tinyllama")
    adapter = lm.init_adapter(cfg, torch.Generator().manual_seed(0))
    toks = torch.tensor(_tokens(10, cfg, 2, cfg.seq_len))
    a, _ = forward(cfg.model, base, {"tokens": toks})
    b, _ = forward(cfg.model, lm.merge_lora(cfg, adapter, base),
                   {"tokens": toks})
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# data, layout, registry, pricing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,vocab,n", [(0, 256, 48), (3, 50280, 21),
                                         (17, 32000, 5)])
def test_make_lm_dataset_is_byte_identical(seed, vocab, n):
    got = make_lm_dataset(n, 32, vocab, seed=seed)
    want = ref_make_lm_dataset(n, 32, vocab, seed=seed)
    assert got.images.dtype == want.images.dtype
    assert got.images.tobytes() == np.asarray(want.images).tobytes()
    assert got.labels.tobytes() == np.asarray(want.labels).tobytes()
    assert got.num_classes == want.num_classes


@pytest.mark.parametrize("arch,full,p_adapter", [
    ("tinyllama-1.1b", False, 3328), ("mamba2-130m", False, 8512),
    ("tinyllama-1.1b", True, 563_200), ("mamba2-130m", True, 616_704)])
def test_adapter_flat_spec_matches_reference(arch, full, p_adapter):
    """From shapes only: nothing of the full models is allocated."""
    if full:
        cfg = lm.LMConfig(model=get_config(arch))
        ref_cfg = ref_lm.LMConfig(model=ref_get_config(arch))
    else:
        name = "tinyllama" if arch.startswith("tiny") else arch
        cfg, ref_cfg = workload_config(name), ref_workload_config(name)
    got, want = model_flat_spec(cfg), ref_model_flat_spec(ref_cfg)
    assert got.names == want.names
    assert got.shapes == want.shapes
    assert got.offsets == want.offsets
    assert got.total == want.total == lm.adapter_num_params(cfg) == p_adapter
    assert cfg.model.num_params() == ref_cfg.model.num_params()


def test_nested_params_round_trip_in_jax_order():
    """``params_from_jax`` names a nested tree's leaves by their key paths;
    a flattened row is the reference's row; ``params_to_jax`` nests them
    back."""
    from repro_torch.utils.trees import (flatten_vector, params_to_jax,
                                         stack_flatten_spec)
    _, ref_cfg, _, _ = _cfgs("mamba2-130m")
    tree = jax.tree_util.tree_map(np.asarray, ref_lm.init_adapter(
        ref_cfg, jax.random.PRNGKey(5)))
    tree["blocks"]["a.b"] = np.ones((2,), np.float32)   # sorts before "mamba"
    flat = params_from_jax(tree)
    assert "blocks/mamba/in_proj_a" in flat
    np.testing.assert_array_equal(
        flatten_vector(stack_flatten_spec(flat), flat).numpy(),
        np.asarray(tree_flatten_vector(tree)))
    back = params_to_jax(flat)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_feature_layer_resolves_nested_names_like_the_reference():
    """A bare leaf name resolves through the adapter's nested paths
    (``wv_b`` -> ``blocks/attn/wv_b``), and ``auto`` takes the last leaf
    where there is no ``w_fc2`` or ``lm_head``."""
    cfg, ref_cfg = workload_config("tinyllama"), ref_workload_config(
        "tinyllama")
    spec, ref_spec = model_flat_spec(cfg), ref_model_flat_spec(ref_cfg)
    for layer in ("wv_b", "wq_a", "blocks/attn/wv_a", "auto", "all"):
        assert (resolve_feature_columns(spec, layer)
                == ref_resolve(ref_spec, layer))
    with pytest.raises(KeyError):
        resolve_feature_columns(spec, "w_fc2")


def test_registry_knows_the_lm_workloads():
    assert set(ARCHS) <= set(workload_names())
    cfg = workload_config("tinyllama")
    assert isinstance(cfg, lm.LMConfig)
    mdef = model_def_for(cfg)
    assert mdef.name == "lora-lm" and mdef.price_uploads
    with pytest.raises(ValueError, match="unknown model"):
        workload_config("gpt-17")
    with pytest.raises(ValueError, match="tinyllama"):
        ExperimentSpec(model="gpt-17")


# ---------------------------------------------------------------------------
# the slice: the reference's host loop against the port's
# ---------------------------------------------------------------------------


class JaxReplayDraws:
    """The reference experiment's key stream behind the port's draws
    interface (init, initial-round training, K-means, one per round), plus
    the reference's frozen base."""

    def __init__(self, seed, ref_cfg):
        self.key = jax.random.PRNGKey(seed)
        self.ref_cfg = ref_cfg

    def _next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def init_params(self, model_cfg):
        return params_from_jax(jax.tree_util.tree_map(
            np.asarray, ref_lm.init_adapter(self.ref_cfg, self._next())))

    def base_params(self, model_cfg):
        return params_from_jax(jax.tree_util.tree_map(
            np.asarray, ref_lm.base_params(self.ref_cfg)))

    def batch_indices(self, n, local_iters, batch_size, num_samples):
        keys = jax.random.split(self._next(), n)
        idx = [[np.asarray(jax.random.randint(k, (batch_size,), 0,
                                              num_samples))
                for k in jax.random.split(key, local_iters)] for key in keys]
        return torch.tensor(np.asarray(idx), dtype=torch.long)

    def kmeans_seed(self, n, c):
        self.km_keys = jax.random.split(self._next(), c)
        self.km_n = n
        return torch.tensor(int(jax.random.randint(self.km_keys[0], (), 0,
                                                    n)))

    def kmeans_choice(self, i, p):
        return torch.tensor(int(jax.random.choice(
            self.km_keys[i], self.km_n, p=jnp.asarray(p.numpy()))))


@pytest.fixture(scope="module", params=ARCHS)
def slice_runs(request):
    arch = request.param
    ref = ref_build_experiment(RefSpec(model=arch, **TINY_LM))
    port = build_experiment(ExperimentSpec(model=arch, **TINY_LM),
                            device="cpu",
                            draws=JaxReplayDraws(0, ref.model_cfg))
    out = {"init": (np.asarray(tree_flatten_vector(ref.global_params)),
                    port.global_vec.numpy().copy()),
           "z": (np.asarray(ref.fleet.z), port.fleet.z)}
    for exp, side in ((ref, "ref"), (port, "port")):
        exp.initial_round()
        acc0, _ = exp.evaluate()
        T0, E0 = exp.allocate(np.arange(TINY_LM["clients"]))
        hist = [(np.arange(TINY_LM["clients"]), float(T0), float(E0), acc0)]
        for _ in range(2):
            r = exp.round()
            hist.append((np.asarray(r.selected), float(r.T_k), float(r.E_k),
                         float(r.accuracy)))
        out[side] = hist
    out["labels"] = (np.asarray(ref.cluster_labels), port.cluster_labels)
    out["global"] = (np.asarray(tree_flatten_vector(ref.global_params)),
                     port.global_vec.numpy())
    out["plane"] = (np.asarray(ref.client_params), port.client_plane.numpy())
    out["p"] = port.global_vec.numel()
    return out


def test_slice_initial_rows_and_clusters_equal(slice_runs):
    ref0, port0 = slice_runs["init"]
    assert np.array_equal(ref0, port0)
    np.testing.assert_array_equal(*slice_runs["labels"])


def test_slice_selections_equal(slice_runs):
    for (sel_r, *_), (sel_p, *_) in zip(slice_runs["ref"], slice_runs["port"]):
        np.testing.assert_array_equal(sel_p, sel_r)


def test_slice_T_and_E_match(slice_runs):
    for (_, T_r, E_r, _), (_, T_p, E_p, _) in zip(slice_runs["ref"],
                                                  slice_runs["port"]):
        np.testing.assert_allclose(T_p, T_r, rtol=2e-3)
        np.testing.assert_allclose(E_p, E_r, rtol=2e-3)


def test_slice_global_row_and_plane_match(slice_runs):
    np.testing.assert_allclose(slice_runs["global"][1],
                               slice_runs["global"][0], atol=1e-4)
    np.testing.assert_allclose(slice_runs["plane"][1],
                               slice_runs["plane"][0], atol=1e-4)
    assert np.abs(slice_runs["plane"][0]).max() > 0


def test_slice_accuracy_within_one_test_token(slice_runs):
    tokens = TINY_LM["test_samples"] * 32
    for (*_, acc_r), (*_, acc_p) in zip(slice_runs["ref"], slice_runs["port"]):
        assert abs(acc_p - acc_r) <= 1.0 / tokens + 1e-6


def test_slice_uploads_priced_at_the_adapter_size(slice_runs):
    z_ref, z_port = slice_runs["z"]
    np.testing.assert_allclose(z_port, slice_runs["p"] * 32 / 1e6)
    np.testing.assert_allclose(z_port, z_ref)
