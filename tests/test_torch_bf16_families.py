"""The port's MoE, hybrid, SSM and encoder-decoder stacks in bfloat16
against the reference's, on the CPU at the smoke configs (the check of
``test_torch_bf16.py``, which holds the dense and VLM stacks), an fp32
decode cache under a bf16 model, and one bf16 train step against the
reference's jitted step.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models import transformer as RT
from repro.train import train_step as ref_train

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.models import transformer as T
from repro_torch.train.train_step import make_train_step
from repro_torch.utils.trees import params_from_jax, tensor_to_numpy

from test_torch_bf16 import (B, CACHE, DENSE_ARCHS, STEPS, _reference,
                             _widen, check_stack)

FAMILY_ARCHS = tuple(a for a in configs.ARCH_IDS if a not in DENSE_ARCHS)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_bf16_stack_matches_the_reference(arch, monkeypatch):
    check_stack(arch, monkeypatch)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_an_fp32_cache_serves_a_bf16_model(arch):
    """bf16 parameters over an fp32 cache (the serve engine's default): the
    new k, v (and conv state) are written in the cache's dtype, exactly,
    so the steps give the bf16 cache's logits bit for bit. (The
    reference's ``dynamic_update_slice`` refuses the mixed pair.)"""
    cfg, params, batch, _, _ = _reference(arch)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    caches = [T.init_cache(cfg, B, CACHE, dtype=dt)
              for dt in (torch.bfloat16, torch.float32)]
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            ck, cv = T.encode_memory(cfg, params, tb)
            for c in caches:
                c["cross_k"], c["cross_v"] = ck, cv
        for t in range(STEPS):
            got = [T.decode_step(cfg, params,
                                 {"tokens": tb["tokens"][:, t:t + 1]}, c)[0]
                   for c in caches]
            assert got[0].dtype == got[1].dtype == torch.bfloat16
            assert torch.equal(got[0], got[1])
    for name, leaf in caches[1].items():
        if leaf.is_floating_point():
            assert leaf.dtype == torch.float32, name


def test_bf16_train_step_matches_the_reference():
    """One AdamW step of ``make_train_step`` on bf16 parameters against
    the reference's jitted step: the loss and the gradient norm within the
    bf16 bound, the parameters kept in bf16 and the moments in fp32; the
    updated parameters within two bf16 steps of the reference's."""
    arch = "tinyllama-1.1b"
    ref_cfg = ref_configs.get_smoke_config(arch)
    p16 = RT.init_model(ref_cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tokens = np.random.default_rng(1).integers(
        0, ref_cfg.vocab_size, (4, 16)).astype(np.int32)
    tc = dict(total_steps=10, warmup_steps=1)
    want = {}
    for name, params in (("bf16", p16), ("fp32", _widen(p16))):
        init, step = ref_train.make_train_step(ref_cfg,
                                               RefTrainConfig(**tc))
        want[name] = jax.jit(step)(params, init(params),
                                   {"tokens": jnp.asarray(tokens)})
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, p16))
    init, step = make_train_step(configs.get_smoke_config(arch),
                                 TrainConfig(**tc))
    new, state, m = step(port, init(port), {"tokens": torch.tensor(tokens)})
    (r16, _, m16), (r32, _, m32) = want["bf16"], want["fp32"]
    for k in ("loss", "gnorm"):
        bound = 2 * abs(float(m16[k]) - float(m32[k]))
        assert abs(float(m[k]) - float(m16[k])) <= bound, k
    assert all(v.dtype == torch.bfloat16 for v in new.values())
    assert all(v.dtype == torch.float32 for v in state.m.values())
    assert all(v.dtype == torch.float32 for v in state.v.values())
    ref16, ref32 = (params_from_jax(jax.tree_util.tree_map(np.asarray, r))
                    for r in (r16, r32))
    same = 0
    for k, v in new.items():
        err = float((v.float() - ref16[k].float()).abs().max())
        assert err <= 2 * float((ref16[k].float() - ref32[k]).abs().max()), k
        same += int((v == ref16[k]).sum())
    # AdamW's first step moves each weight by about lr·sign(g): only the
    # weights whose tiny gradient changes sign between the packages differ
    assert same >= 0.99 * sum(v.numel() for v in new.values())
    assert tensor_to_numpy(new["embed"]).dtype.name == "bfloat16"
