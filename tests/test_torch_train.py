"""The port's LM training stack against the reference's, on the CPU.

``cosine_schedule``, ``clip_by_global_norm``, ``cross_entropy`` and one
``make_optimizer`` update (adamw, sgd, momentum, and adamw with bf16
moments) take the same numpy inputs in both packages: fp32 results within
rtol 1e-5 / atol 1e-6 (the same formula in another summation order), a
bf16 moment within one bf16 step (rtol 2**-7). Three ``make_train_step``
steps on both smoke families start from the reference's ``init_model``
parameters (carried over by ``params_from_jax``) on the same batches:
losses within rtol 1e-4, parameters within rtol 1e-4 / atol 2e-5. The
atol is lr/50 at lr 1e-3: AdamW's step m̂/(√v̂ + ε) is scale-free, so an
element whose gradient is as small as fp32's rounding in either
package's summation order moves by up to lr either way (2 of 32,768
elements of tinyllama's ``wo`` differ by 1.04e-5 after three steps).
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
from repro.train.optimizer import clip_by_global_norm as ref_clip
from repro.train.optimizer import cosine_schedule as ref_cosine
from repro.train.optimizer import make_optimizer as ref_make_optimizer
from repro.train.train_step import cross_entropy as ref_cross_entropy
from repro.train.train_step import make_train_step as ref_make_train_step
from repro.utils.trees import tree_bytes as ref_tree_bytes
from repro.utils.trees import tree_global_norm as ref_global_norm
from repro.utils.trees import tree_num_params as ref_num_params

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.train.optimizer import (clip_by_global_norm, cosine_schedule,
                                         make_optimizer)
from repro_torch.train.train_step import cross_entropy, make_train_step
from repro_torch.utils.trees import (params_from_jax, params_to_jax,
                                     tree_bytes, tree_global_norm,
                                     tree_num_params)

TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)     # lr 1e-3 / 50


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(4, 6)).astype(np.float32),
                  "b": rng.normal(size=(6,)).astype(np.float32)},
            "z": (rng.normal(size=(3, 2, 5)) * 0.1).astype(np.float32)}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat_np(params):
    return {k: v.detach().float().numpy() for k, v in params.items()}


def test_trainconfig_fields_match_the_reference():
    assert TrainConfig().__dict__ == RefTrainConfig().__dict__


def test_tree_helpers_match_the_reference():
    tree = _tree(0)
    port = params_from_jax(tree)
    np.testing.assert_allclose(float(tree_global_norm(port)),
                               float(ref_global_norm(_jax(tree))), **TOL)
    assert tree_num_params(port) == ref_num_params(tree)
    assert tree_bytes(port) == ref_tree_bytes(_jax(tree))


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 5), (0, 3)])
def test_cosine_schedule_matches_the_reference(warmup, total):
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    ref, port = ref_cosine(RefTrainConfig(**kw)), cosine_schedule(
        TrainConfig(**kw))
    steps = np.arange(0, total + 3, dtype=np.int32)
    want = np.asarray(ref(jnp.asarray(steps)))
    got = port(torch.as_tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    tree = _tree(1)
    ref_g, ref_n = ref_clip(_jax(tree), max_norm)
    got_g, got_n = clip_by_global_norm(params_from_jax(tree), max_norm)
    np.testing.assert_allclose(float(got_n), float(ref_n), **TOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_g))
    for k, v in want.items():
        np.testing.assert_allclose(got_g[k].numpy(), v.numpy(), **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_the_reference(masked, smoothing):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32) if masked else None
    want = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                             None if mask is None else jnp.asarray(mask),
                             smoothing)
    got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(targets),
                        None if mask is None else torch.as_tensor(mask),
                        smoothing)
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("optimizer,moments", [
    ("adamw", "float32"), ("adamw", "bfloat16"), ("sgd", "float32"),
    ("momentum", "float32")])
def test_optimizer_updates_match_the_reference(optimizer, moments):
    """Two updates on fed gradients (the second one clipped)."""
    cfg = dict(optimizer=optimizer, moment_dtype=moments, warmup_steps=2,
               total_steps=10, learning_rate=1e-2, grad_clip=1.0)
    r_init, r_update = ref_make_optimizer(RefTrainConfig(**cfg))
    p_init, p_update = make_optimizer(TrainConfig(**cfg))
    r_params = _jax(_tree(3))
    params = params_from_jax(_tree(3))
    r_state, state = r_init(r_params), p_init(params)
    for step, scale in ((0, 0.1), (1, 5.0)):
        grads = jax.tree_util.tree_map(lambda x: x * scale, _tree(10 + step))
        r_params, r_state, r_stats = r_update(_jax(grads), r_state, r_params)
        params, state, stats = p_update(params_from_jax(grads), state, params)
        np.testing.assert_allclose(float(stats["lr"]), float(r_stats["lr"]),
                                   **TOL)
        np.testing.assert_allclose(float(stats["gnorm"]),
                                   float(r_stats["gnorm"]), **TOL)
    assert int(state.step) == int(r_state.step) == 2
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, r_params))
    for k, v in want.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), **TOL)
    moment_tol = TOL if moments == "float32" else dict(rtol=2 ** -7, atol=0)
    for slot in ("m", "v"):
        r_slot, slot_ = getattr(r_state, slot), getattr(state, slot)
        assert (r_slot is None) == (slot_ is None)
        if slot_ is None:
            continue
        want = jax.tree_util.tree_map(
            lambda x: np.asarray(x.astype(jnp.float32)), r_slot)
        for k, v in params_from_jax(want).items():
            assert slot_[k].dtype == (torch.bfloat16 if moments == "bfloat16"
                                      and optimizer == "adamw"
                                      else torch.float32)
            np.testing.assert_allclose(slot_[k].float().numpy(), v.numpy(),
                                       **moment_tol)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_three_train_steps_match_the_reference(arch):
    cfg, ref_cfg = get_smoke_config(arch), ref_smoke_config(arch)
    kw = dict(learning_rate=1e-3, total_steps=3, warmup_steps=1)
    r_params = ref_init_model(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, r_params))
    r_init, r_step = ref_make_train_step(ref_cfg, RefTrainConfig(**kw),
                                         q_chunk=16, kv_chunk=16)
    p_init, p_step = make_train_step(cfg, TrainConfig(**kw))
    r_state, state = r_init(r_params), p_init(params)
    r_step = jax.jit(r_step)
    rng = np.random.default_rng(4)
    for _ in range(3):
        tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        r_params, r_state, r_m = r_step(r_params, r_state,
                                        {"tokens": jnp.asarray(tokens)})
        params, state, m = p_step(params, state,
                                  {"tokens": torch.as_tensor(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]),
                                   **STEP_TOL)
        np.testing.assert_allclose(float(m["gnorm"]), float(r_m["gnorm"]),
                                   **STEP_TOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, r_params))
    got = _flat_np(params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v.numpy(), err_msg=k, **PARAM_TOL)
    assert set(params_to_jax(params)) == set(r_params)


def test_remat_gives_the_same_step():
    """``TrainConfig.remat`` recomputes blocks in the backward pass: the
    same loss and update."""
    cfg = get_smoke_config("tinyllama-1.1b")
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, ref_init_model(ref_smoke_config("tinyllama-1.1b"),
                                   jax.random.PRNGKey(1))))
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 12)))
    out = []
    for remat in (False, True):
        init, step = make_train_step(cfg, TrainConfig(remat=remat))
        p, _, m = step(params, init(params), {"tokens": tokens})
        out.append((p, float(m["loss"])))
    assert out[0][1] == out[1][1]
    for k in params:
        torch.testing.assert_close(out[0][0][k], out[1][0][k], rtol=0,
                                   atol=0)
