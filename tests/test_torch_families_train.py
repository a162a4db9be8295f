"""Training and the entry points over the new families, against the
reference on the CPU at the smoke configs.

Three ``make_train_step`` steps for granite-moe (``dense`` and
``dispatch``), jamba and seamless start from the reference's
``init_model`` parameters on the same batches and are held at
``tests/test_torch_train.py``'s tolerances (losses rtol 1e-4, parameters
rtol 1e-4 / atol 2e-5). AdamW's step m̂/(√v̂ + ε) is scale-free, so an
element whose gradient is as small as fp32's rounding moves by up to lr a
step either way; at these widths a few such elements of a leaf (1 of
32,768 of seamless's ``decoder/attn/wk``) pass atol, so a leaf may hold
one element in 10,000 outside the tolerance, each within the 2·lr·steps
such a sign can move it. The gradients themselves are held normwise: max
|g − w| ≤ 1e-4 · max |w| for every leaf (the port's SSD runs the
recurrence on the CPU where the reference runs its chunked form: jamba's
``A_log`` gradient, a sum over every step, differs by 1.5e-5 of its
largest; every other leaf by under 1e-5). The entry points and the LoRA
workload over the new families are in ``test_torch_families_launch.py``.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models.transformer import init_model as ref_init_model
from repro.train.train_step import make_loss_fn as ref_make_loss_fn
from repro.train.train_step import make_train_step as ref_make_train_step

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.train.train_step import make_loss_fn, make_train_step
from repro_torch.utils.trees import params_from_jax

STEP_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_NORMWISE = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)     # lr 1e-3 / 50
TRAIN_CASES = [("granite-moe-3b-a800m", "dense"),
               ("granite-moe-3b-a800m", "dispatch"),
               ("jamba-1.5-large-398b", "dense"),
               ("seamless-m4t-medium", "dense")]


def _batch(cfg, rng, b=2, s=16):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.normal(size=(b, 10, cfg.d_model)).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch,moe_impl", TRAIN_CASES)
def test_three_train_steps_match_the_reference(arch, moe_impl):
    """Loss, ce and aux (the load-balance loss added to the loss) each
    step, then the parameters."""
    cfg, ref_cfg = get_smoke_config(arch), ref_smoke_config(arch)
    kw = dict(learning_rate=1e-3, total_steps=3, warmup_steps=1)
    r_params = ref_init_model(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, r_params))
    chunks = dict(q_chunk=8, kv_chunk=8)
    r_init, r_step = ref_make_train_step(ref_cfg, RefTrainConfig(**kw),
                                         moe_impl=moe_impl, **chunks)
    p_init, p_step = make_train_step(cfg, TrainConfig(**kw),
                                     moe_impl=moe_impl, **chunks)
    r_state, state = r_init(r_params), p_init(params)
    r_step = jax.jit(r_step)
    rng = np.random.default_rng(4)
    for _ in range(3):
        batch = _batch(cfg, rng)
        r_params, r_state, r_m = r_step(
            r_params, r_state, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = p_step(
            params, state, {k: torch.as_tensor(v) for k, v in batch.items()})
        for key in ("loss", "ce", "aux", "gnorm"):
            np.testing.assert_allclose(float(m[key]), float(r_m[key]),
                                       err_msg=key, **STEP_TOL)
        assert (float(m["aux"]) > 0) == (cfg.moe is not None)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, r_params))
    assert set(params) == set(want)
    for k, v in want.items():
        got, v = params[k].numpy(), v.numpy()
        off = ~np.isclose(got, v, **PARAM_TOL)
        assert off.sum() <= max(1, off.size // 10_000), k
        assert np.all(np.abs(got - v)[off] <= 2 * kw["learning_rate"] * 3), k


@pytest.mark.parametrize("arch,moe_impl", TRAIN_CASES)
def test_loss_gradients_match_the_reference(arch, moe_impl):
    cfg, ref_cfg = get_smoke_config(arch), ref_smoke_config(arch)
    r_params = ref_init_model(ref_cfg, jax.random.PRNGKey(1))
    chunks = dict(moe_impl=moe_impl, q_chunk=8, kv_chunk=8)
    batch = _batch(cfg, np.random.default_rng(5))
    (r_loss, r_parts), r_grads = jax.jit(jax.value_and_grad(
        ref_make_loss_fn(ref_cfg, RefTrainConfig(), **chunks), has_aux=True))(
        r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {k: v.requires_grad_(True) for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, r_params)).items()}
    loss, parts = make_loss_fn(cfg, TrainConfig(), **chunks)(
        leaves, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss), float(r_loss), **STEP_TOL)
    np.testing.assert_allclose(float(parts["aux"]), float(r_parts["aux"]),
                               **STEP_TOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, r_grads))
    for name, g in zip(leaves, grads):
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_NORMWISE * np.abs(w).max(), (name, err)
