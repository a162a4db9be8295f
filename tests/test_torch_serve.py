"""The port's decode path and serving engine against the reference's, on
the CPU.

Parameters come from the reference's ``init_model`` (smoke configs: 2
layers, d = 128, vocab 256) through ``params_from_jax``. The decode
pieces take the same numpy inputs in both packages: within atol 1e-5
(fp32, another summation order; the reference reaches no Pallas kernel on
decode). ``decode_step`` over 12 steps, with a full cache and with a ring
buffer of 5 slots, gives logits within atol 1e-5 of the reference's; the
greedy tokens of ``ServeEngine.generate`` are equal; ``temperature`` with
``top_k`` fed the reference's Gumbel noise draws the reference's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import sampler as ref_sampler

from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine, sampler
from repro_torch.utils.trees import params_from_jax

ARCHS = ["tinyllama-1.1b", "mamba2-130m"]
TOL = dict(rtol=0, atol=1e-5)
STEPS = 12


def _params(arch, seed=0):
    ref = RT.init_model(ref_smoke_config(arch), jax.random.PRNGKey(seed))
    return ref, params_from_jax(jax.tree_util.tree_map(np.asarray, ref))


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,valid", [(None, False), (4, True)])
def test_full_attention_1q_matches_the_reference(window, valid):
    rng = np.random.default_rng(0)
    B, C, H, K, D = 2, 9, 8, 2, 16
    q, k, v = (_normal(rng, B, 1, H, D), _normal(rng, B, C, K, D),
               _normal(rng, B, C, K, D))
    k_pos = np.stack([rng.permutation(C), np.arange(C)]).astype(np.int32)
    q_pos = np.array([7, 8], np.int32)
    kv_valid = rng.random((B, C)) < 0.7 if valid else None
    want = RL.full_attention_1q(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_pos),
        jnp.asarray(q_pos), window=window,
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
    got = L.full_attention_1q(
        *map(torch.as_tensor, (q, k, v, k_pos, q_pos)), window=window,
        kv_valid=None if kv_valid is None else torch.as_tensor(kv_valid))
    _close(got, want)


def test_ssd_decode_step_and_conv_step_match_the_reference():
    rng = np.random.default_rng(1)
    B, H, P, G, N, W, Cc = 2, 4, 8, 2, 16, 4, 12
    x, dt = _normal(rng, B, H, P), np.abs(_normal(rng, B, H, scale=0.1))
    a_raw = -np.abs(_normal(rng, H))
    bm, cm = _normal(rng, B, G, N), _normal(rng, B, G, N)
    d, state = _normal(rng, H), _normal(rng, B, H, P, N)
    want = RL.ssd_decode_step(*map(jnp.asarray, (x, dt, a_raw, bm, cm, d,
                                                 state)))
    got = L.ssd_decode_step(*map(torch.as_tensor, (x, dt, a_raw, bm, cm, d,
                                                   state)))
    for g, w in zip(got, want):
        _close(g, w)
    x_t, conv = _normal(rng, B, Cc), _normal(rng, B, W - 1, Cc)
    w_, b_ = _normal(rng, W, Cc), _normal(rng, Cc)
    want = RL.causal_conv1d_step(*map(jnp.asarray, (x_t, conv, w_, b_)))
    got = L.causal_conv1d_step(*map(torch.as_tensor, (x_t, conv, w_, b_)))
    for g, w in zip(got, want):
        _close(g, w)


def test_mamba2_decode_matches_the_reference():
    arch = "mamba2-130m"
    cfg, ref_cfg = get_smoke_config(arch), ref_smoke_config(arch)
    ref, port = _params(arch)
    rp = jax.tree_util.tree_map(lambda v: v[0], ref["blocks"]["mamba"])
    pp = {k[len("blocks/mamba/"):]: v[0] for k, v in port.items()
          if k.startswith("blocks/mamba/")}
    rng = np.random.default_rng(2)
    _, n_heads, conv_ch = L.mamba2_split_dims(cfg)
    s = cfg.ssm
    x_t = _normal(rng, 2, cfg.d_model)
    ssm = _normal(rng, 2, n_heads, s.head_dim, s.d_state, scale=0.1)
    conv = _normal(rng, 2, s.conv_width - 1, conv_ch)
    want = RL.mamba2_decode(rp, jnp.asarray(x_t), ref_cfg, jnp.asarray(ssm),
                            jnp.asarray(conv))
    got = L.mamba2_decode(pp, torch.as_tensor(x_t), cfg,
                          torch.as_tensor(ssm), torch.as_tensor(conv))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_the_reference(arch, window):
    """12 steps over a cache of 16 positions, or a ring buffer of 5 slots
    (``slot = pos mod 5``; the attention sees the last 5 tokens)."""
    cfg, ref_cfg = get_smoke_config(arch), ref_smoke_config(arch)
    ref, port = _params(arch)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, STEPS)).astype(np.int32)
    r_cache = RT.init_cache(ref_cfg, 2, 16, window=window)
    cache = T.init_cache(cfg, 2, 16, window=window)
    step = jax.jit(lambda p, b, c: RT.decode_step(ref_cfg, p, b, c))
    for t in range(STEPS):
        want, r_cache = step(ref, {"tokens": jnp.asarray(tokens[:, t:t + 1])},
                             r_cache)
        got, cache = T.decode_step(cfg, port, {"tokens": torch.as_tensor(
            tokens[:, t:t + 1])}, cache)
        _close(got, want)
    assert int(cache["pos"]) == int(r_cache["pos"]) == STEPS
    if "attn/k_pos" in cache:
        np.testing.assert_array_equal(cache["attn/k_pos"].numpy(),
                                      np.asarray(r_cache["attn"]["k_pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_matches_the_reference(arch):
    cfg, ref_cfg = get_smoke_config(arch), ref_smoke_config(arch)
    ref, port = _params(arch)
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 6)).astype(np.int32)
    want = RefServeEngine(ref_cfg, ref, max_len=32).generate(
        jnp.asarray(prompts), num_tokens=8)
    got = ServeEngine(cfg, port, max_len=32).generate(
        torch.as_tensor(prompts), num_tokens=8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k", [0, 3])
def test_temperature_on_the_references_noise(top_k):
    """``jax.random.categorical(key, l)`` is ``argmax(l + gumbel(key))``:
    fed that noise, the port draws the reference's tokens."""
    rng = np.random.default_rng(5)
    logits = _normal(rng, 64, 10, scale=2.0)
    logits[:, 4] = logits[:, 5]                   # a tie at the k-th value
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = ref_sampler.temperature(jnp.asarray(logits), key, temp=0.7,
                                       top_k=top_k)
        noise = jax.random.gumbel(key, logits.shape)
        got = sampler.temperature(torch.as_tensor(logits), temp=0.7,
                                  top_k=top_k,
                                  gumbel=torch.as_tensor(np.array(noise)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_top_k_stays_in_the_top_k():
    logits = torch.tensor([[10.0, 9.0, -5.0, -5.0]])
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        assert int(sampler.temperature(logits, gen, top_k=2)[0]) in (0, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_matches_forward_argmax(arch):
    """Greedy one-step continuation == argmax of ``forward``'s logits (the
    port's counterpart of ``tests/test_serve.py``)."""
    cfg = get_smoke_config(arch)
    _, port = _params(arch)
    prompts = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (3, 10)))
    gen = ServeEngine(cfg, port, max_len=64).generate(prompts, num_tokens=1)
    with torch.no_grad():
        want = torch.argmax(
            T.forward(cfg, port, {"tokens": prompts})[0][:, -1], dim=-1)
    np.testing.assert_array_equal(gen[:, 0], want.numpy())
