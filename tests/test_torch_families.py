"""The model families the port gained beside tinyllama and mamba2 — MoE
(granite, mixtral), hybrid (jamba), encoder-decoder (seamless), VLM
(phi-3-vision) and the dense minitron and qwen2 — against the reference,
on the CPU at their smoke configs.

Each architecture's parameters are the reference's ``init_model`` tree,
carried over by ``params_from_jax``; its inputs are numpy draws from a
seed. ``forward``'s logits and aux, ``encode_memory`` and a few
``decode_step``s agree within 1e-5. The configs equal the reference's
field for field, ``init_model`` draws the reference's tree, and the
packages export the reference's names.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as RT

from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.utils.trees import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)   # 20 steps' fp32 drift, as on the card
NEW_ARCHS = ("granite-moe-3b-a800m", "jamba-1.5-large-398b", "minitron-8b",
             "mixtral-8x22b", "phi-3-vision-4.2b", "qwen2-1.5b",
             "qwen2-72b", "seamless-m4t-medium")
B, S, S_ENC = 2, 20, 12


@functools.lru_cache(maxsize=None)
def _arch(arch):
    """(port config, reference config, port params, reference params)."""
    ref_cfg = ref_configs.get_smoke_config(arch)
    ref = RT.init_model(ref_cfg, jax.random.PRNGKey(0))
    return (configs.get_smoke_config(arch), ref_cfg,
            params_from_jax(jax.tree_util.tree_map(np.asarray, ref)), ref)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.normal(
            size=(B, S_ENC, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_the_references(arch):
    for get in ("get_config", "get_smoke_config"):
        got, want = getattr(configs, get)(arch), getattr(ref_configs,
                                                         get)(arch)
        assert repr(got) == repr(want)
        assert got.num_params() == want.num_params()


def test_arch_ids_and_input_shapes_are_the_references():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert set(NEW_ARCHS) | {"tinyllama-1.1b", "mamba2-130m"} == set(
        configs.ARCH_IDS)
    for name, shape in ref_configs.INPUT_SHAPES.items():
        assert repr(configs.get_input_shape(name)) == repr(shape)
        assert configs.get_input_shape(name).is_decode == shape.is_decode
    assert configs.LONG_CONTEXT_WINDOW == ref_configs.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_model_draws_the_references_tree(arch):
    cfg, _, want, _ = _arch(arch)
    got = T.init_model(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_the_reference(arch):
    """Logits and aux (the MoE layers' load-balance loss; a VLM's image
    embeddings in place of its first tokens; an encoder-decoder's frame
    embeddings through the encoder)."""
    cfg, ref_cfg, port, ref = _arch(arch)
    rb, pb = _both(_batch(cfg))
    want, want_aux = RT.forward(ref_cfg, ref, rb)
    got, aux = T.forward(cfg, port, pb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert (float(aux) > 0) == (cfg.moe is not None)


def test_vlm_image_embeds_replace_the_first_tokens():
    cfg, ref_cfg, port, ref = _arch("phi-3-vision-4.2b")
    batch = _batch(cfg)
    plain = {"tokens": torch.tensor(batch["tokens"])}
    with_img, _ = T.forward(cfg, port, _both(batch)[1])
    without, _ = T.forward(cfg, port, plain)
    assert not torch.allclose(with_img, without)
    # the image tokens' embeddings are what moves: the same embeddings in
    # place of the tokens give the same logits
    emb = port["embed"][plain["tokens"].long()].clone()
    n = cfg.num_image_tokens
    same = dict(plain, image_embeds=emb[:, :n])
    torch.testing.assert_close(T.forward(cfg, port, same)[0], without,
                               rtol=0, atol=0)


def test_encode_memory_matches_the_reference():
    cfg, ref_cfg, port, ref = _arch("seamless-m4t-medium")
    src = _batch(cfg)["src_embeds"]
    want = RT.encode_memory(ref_cfg, ref, {"src_embeds": jnp.asarray(src)})
    got = T.encode_memory(cfg, port, {"src_embeds": torch.tensor(src)})
    for g, w in zip(got, want):
        assert tuple(g.shape) == (cfg.num_layers, B, S_ENC,
                                  cfg.num_kv_heads, cfg.resolved_head_dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_steps_match_the_reference(arch):
    """Four ``decode_step``s from an empty cache (an encoder-decoder's
    holding ``encode_memory``'s K/V; a ring buffer where the config has a
    window), logits within 1e-5 and the caches' shapes the reference's."""
    cfg, ref_cfg, port, ref = _arch(arch)
    batch = _batch(cfg, seed=1)
    tokens = batch["tokens"]
    r_cache = RT.init_cache(ref_cfg, B, 16, window=cfg.sliding_window)
    cache = T.init_cache(cfg, B, 16, window=cfg.sliding_window)
    if cfg.is_encoder_decoder:
        assert cache["cross_k"].shape == r_cache["cross_k"].shape
        src = batch["src_embeds"]
        r_cache = dict(r_cache)
        r_cache["cross_k"], r_cache["cross_v"] = RT.encode_memory(
            ref_cfg, ref, {"src_embeds": jnp.asarray(src)})
        cache["cross_k"], cache["cross_v"] = T.encode_memory(
            cfg, port, {"src_embeds": torch.tensor(src)})
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, r_cache))
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in flat.items() if k != "cache_len"}
    step = jax.jit(functools.partial(RT.decode_step, ref_cfg))
    for t in range(4):
        want, r_cache = step(ref, {"tokens": jnp.asarray(tokens[:, t:t + 1])},
                             r_cache)
        with torch.no_grad():
            got, cache = T.decode_step(
                cfg, port, {"tokens": torch.tensor(tokens[:, t:t + 1])},
                cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"step {t}", **TOL)
    assert int(cache["pos"]) == 4


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_decode_is_forward(arch):
    """Decoding a sequence token by token gives ``forward``'s logits (the
    hybrid's SSM states and the encoder-decoder's cross K/V carried in the
    cache), within ``chip_smoke.py``'s decode bound of 1e-4."""
    cfg, _, port, _ = _arch(arch)
    _, pb = _both(_batch(cfg, seed=2))
    with torch.no_grad():
        full, _ = T.forward(cfg, port, pb)
        cache = T.init_cache(cfg, B, S)
        if cfg.is_encoder_decoder:
            cache["cross_k"], cache["cross_v"] = T.encode_memory(
                cfg, port, {"src_embeds": pb["src_embeds"]})
        steps = [T.decode_step(cfg, port, {"tokens": pb["tokens"][:, t:t + 1]},
                               cache)[0] for t in range(S)]
    torch.testing.assert_close(torch.cat(steps, dim=1), full, **DECODE_TOL)


def _reference_names(package):
    path = ROOT / "src" / "repro" / package / "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


@pytest.mark.parametrize("package", ["models", "utils", "kernels"])
def test_packages_export_the_references_names(package):
    import importlib
    mod = importlib.import_module(f"repro_torch.{package}")
    for name in _reference_names(package):
        assert getattr(mod, name, None) is not None, name
