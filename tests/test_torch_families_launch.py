"""The entry points and the LoRA workload over the new families, against
the reference on the CPU at the smoke configs.

``launch.train`` and ``launch.serve`` run granite-moe, jamba and seamless
with ``--smoke --device cpu``; ``make_vlm_audio_extras`` gives the
reference's stub inputs. The LoRA workload's loss and adapter gradients
over qwen2-1.5b (QKV bias) and phi-3-vision match the reference's (loss
2e-5, gradients 1e-4, as ``test_torch_lm.py``); over an MoE, hybrid or
encoder-decoder stack both packages refuse with the same words.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve, train
from repro_torch.models import lm
from repro_torch.utils.trees import params_from_jax

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CLI_ARCHS = ("granite-moe-3b-a800m", "jamba-1.5-large-398b",
             "seamless-m4t-medium")


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_launch_train_and_serve_run_the_smoke_config(tmp_path, arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        logger = train.main(["--arch", arch, "--smoke", "--steps", "2",
                             "--batch", "2", "--seq", "16", "--device",
                             "cpu", "--moe-impl", "dispatch",
                             "--log-csv", str(tmp_path / "log.csv")])
        tokens = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                             "--prompt-len", "3", "--gen", "4", "--device",
                             "cpu"])
    assert len(logger.history["loss"]) == 2
    assert all(np.isfinite(logger.history["loss"]))
    cfg = get_smoke_config(arch)
    assert tokens.shape == (2, 4)
    assert ((tokens >= 0) & (tokens < cfg.vocab_size)).all()
    assert "tok/s" in out.getvalue().splitlines()[-3]


def test_vlm_audio_extras_are_the_references():
    from repro.launch.train import make_vlm_audio_extras as ref_extras
    for arch in ("phi-3-vision-4.2b", "seamless-m4t-medium", "qwen2-1.5b"):
        got = train.make_vlm_audio_extras(get_smoke_config(arch), 2, 16)
        want = ref_extras(ref_smoke_config(arch), 2, 16)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        assert all(float(v.abs().sum()) == 0.0 for v in got.values())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi-3-vision-4.2b"])
def test_lora_loss_and_adapter_gradients_match(arch):
    ref_cfg = ref_lm.LMConfig(model=ref_smoke_config(arch), seq_len=12)
    cfg = lm.LMConfig(model=get_smoke_config(arch), seq_len=12)
    base = params_from_jax(jax.tree_util.tree_map(
        np.asarray, ref_lm.base_params(ref_cfg)))
    adapter = ref_lm.init_adapter(ref_cfg, jax.random.PRNGKey(3))
    # nonzero B factors, so the gradients of the A factors are not zero
    adapter = jax.tree_util.tree_map(
        lambda l: l + 0.05 * jax.random.normal(jax.random.PRNGKey(4),
                                               l.shape), adapter)
    toks = np.random.default_rng(9).integers(
        0, cfg.model.vocab_size, (3, cfg.seq_len + 1)).astype(np.int32)
    batch = {"images": jnp.asarray(toks), "labels": jnp.zeros(3, jnp.int32)}
    loss_r, grads_r = jax.jit(jax.value_and_grad(ref_lm.lm_loss),
                              static_argnums=2)(adapter, batch, ref_cfg)
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_jax(adapter).items()}
    assert set(leaves) == set(lm.adapter_shapes(cfg))
    loss = lm.lm_loss(leaves, torch.tensor(toks), cfg, base)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_r),
                               **FWD_TOL)
    want = params_from_jax(grads_r)
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
        assert float(g.abs().sum()) > 0.0


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_lora_refuses_moe_hybrid_and_encdec_with_the_references_words(arch):
    with pytest.raises(ValueError) as want:
        ref_lm.adapter_targets(ref_lm.LMConfig(model=ref_smoke_config(arch)))
    with pytest.raises(ValueError) as got:
        lm.adapter_targets(lm.LMConfig(model=get_smoke_config(arch)))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="homogeneous dense/ssm"):
        lm.base_params(lm.LMConfig(model=get_smoke_config(arch)))
