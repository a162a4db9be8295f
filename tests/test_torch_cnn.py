"""The port's paper CNN against the reference: the same weights (carried
across with ``params_from_jax``) and images give the same logits, loss and
gradient, and the L-step local update fed the reference's batch indices
gives the same client models. Both sides run fp32 on the CPU; the
tolerances cover summation-order differences only."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNN_CONFIGS as REF_CNN_CONFIGS
from repro.core.engine import make_local_update as ref_make_local_update
from repro.models import cnn as ref_cnn

from repro_torch.configs.paper_cnn import CNN_CONFIGS
from repro_torch.core.engine import make_local_update, model_flat_spec
from repro_torch.models.cnn import (cnn_forward, cnn_loss, cnn_param_shapes,
                                    init_cnn)
from repro_torch.utils.trees import params_from_jax


def _ref_params(dataset, seed=0):
    return ref_cnn.init_cnn(REF_CNN_CONFIGS[dataset], jax.random.PRNGKey(seed))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _batch(dataset, n, seed=1):
    cfg = CNN_CONFIGS[dataset]
    rng = np.random.default_rng(seed)
    h, w = cfg.input_hw
    images = rng.uniform(0, 1, (n, h, w, cfg.input_channels)).astype(
        np.float32)
    labels = rng.integers(0, cfg.num_classes, n).astype(np.int32)
    return images, labels


@pytest.mark.parametrize("dataset", ["mnist", "fashion", "cifar10"])
def test_logits_loss_grad_match_reference(dataset):
    ref_p = _ref_params(dataset)
    images, labels = _batch(dataset, 6)
    cfg, ref_cfg = CNN_CONFIGS[dataset], REF_CNN_CONFIGS[dataset]
    batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    want_logits = np.asarray(ref_cnn.cnn_forward(ref_p, batch["images"],
                                                 ref_cfg))
    want_loss = float(ref_cnn.cnn_loss(ref_p, batch, ref_cfg))
    want_grad = _np(jax.grad(ref_cnn.cnn_loss)(ref_p, batch, ref_cfg))

    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(_np(ref_p)).items()}
    x, y = torch.tensor(images), torch.tensor(labels)
    logits = cnn_forward(params, x, cfg)
    loss = cnn_loss(params, x, y, cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4,
                               atol=1e-5)
    for (k, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want_grad[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_init_shapes_and_scales():
    cfg = CNN_CONFIGS["mnist"]
    ref_p = _ref_params("mnist")
    got = init_cnn(cfg, torch.Generator().manual_seed(0))
    assert list(got) == list(ref_p)
    for k, v in got.items():
        assert tuple(v.shape) == ref_p[k].shape == cnn_param_shapes(cfg)[k]
        assert v.dtype == torch.float32
        if k.startswith("b_"):
            assert float(v.abs().max()) == 0.0
    # weights are N(0, 1/fan_in): the big fc1 matrix pins the scale
    fan_in = cfg.flat_features
    std = float(got["w_fc1"].std()) * np.sqrt(fan_in)
    assert abs(std - 1.0) < 0.02
    assert model_flat_spec(cfg).total == sum(
        int(np.prod(s)) for s in cnn_param_shapes(cfg).values())


@pytest.mark.parametrize("dataset,s,local_iters,batch", [
    ("fashion", 3, 4, 8), ("mnist", 2, 2, 4)])
def test_local_update_matches_reference(dataset, s, local_iters, batch):
    """L SGD steps of S clients at once == the reference's vmapped update,
    fed the reference's own ``randint`` batch indices."""
    lr, d = 0.05, 12
    ref_p = _ref_params(dataset, 2)
    images, labels = _batch(dataset, s * d, seed=5)
    images = images.reshape((s, d) + images.shape[1:])
    labels = labels.reshape(s, d)
    keys = jax.random.split(jax.random.PRNGKey(9), s)
    ref_update = jax.vmap(ref_make_local_update(REF_CNN_CONFIGS[dataset], lr,
                                                local_iters, batch),
                          in_axes=(None, 0, 0, 0))
    want = _np(ref_update(ref_p, jnp.asarray(images), jnp.asarray(labels),
                          keys))
    # the reference's draw: per client, L keys, one randint(batch) each
    idx = np.stack([np.stack([
        np.asarray(jax.random.randint(k, (batch,), 0, d))
        for k in jax.random.split(key, local_iters)]) for key in keys])
    got = make_local_update(CNN_CONFIGS[dataset], lr, local_iters, batch)(
        params_from_jax(_np(ref_p)), torch.tensor(images),
        torch.tensor(labels).long(), torch.tensor(idx, dtype=torch.long))
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-5, err_msg=k)


def test_local_update_rejects_wrong_batch_shape():
    cfg = CNN_CONFIGS["fashion"]
    upd = make_local_update(cfg, 0.05, 2, 4)
    params = init_cnn(cfg, torch.Generator().manual_seed(0))
    images = torch.zeros((2, 5, 28, 28, 1))
    with pytest.raises(ValueError, match="batch_idx"):
        upd(params, images, torch.zeros((2, 5), dtype=torch.long),
            torch.zeros((2, 3, 4), dtype=torch.long))
