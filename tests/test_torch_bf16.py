"""The port's LM stacks in bfloat16 against the reference's, on the CPU at
the smoke configs: the dense and VLM stacks here, the MoE, hybrid, SSM and
encoder-decoder stacks and the train step in ``test_torch_bf16_families.py``
(the same check, split so that each file stays short).

Each architecture's parameters are the reference's ``init_model(...,
dtype=jnp.bfloat16)`` tree, carried over bit for bit by
``params_from_jax``. The reference's outputs are computed once a config
(8 tokens, 2 decode steps over a bf16 cache; ``forward`` and
``decode_step`` jitted, as the reference's engines run them), beside its
own run on the same weights widened to fp32. The port's logits must lie
within twice the reference's own bf16 error: max |port − ref_bf16| ≤ 2 ·
max |ref_bf16 − ref_fp32|, and every tensor comes back in the reference's
dtype.

Routing. A MoE layer picks its experts by the order of bf16 router logits,
and two valid bf16 roundings of the same layer can order a near-tie
either way (a flip moves that token's output by a whole expert). So the
port is held to the bound on the reference's expert choices (recorded
from the reference's run, handed to the port's router), and separately
every choice the port makes on its own that differs from the reference's
must be a near-tie: the two logits it swaps lie closer than twice the
router logits' largest difference between the two packages.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import transformer as RT

from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils.trees import params_from_jax

B, S, STEPS, CACHE = 2, 8, 2, 16
DENSE_ARCHS = ("minitron-8b", "phi-3-vision-4.2b", "tinyllama-1.1b",
               "qwen2-72b", "qwen2-1.5b")


def _widen(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        tree)


def _batch(cfg):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(size=(B, 4, cfg.d_model)).astype(
            np.float32)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.normal(size=(B, 6, cfg.d_model)).astype(
            np.float32)
    return batch


class Routing:
    """The reference's expert choices, in the order its MoE layers run
    (``jax.debug.callback`` from inside the scanned layers), and the
    port's own beside them. ``force`` hands the port the reference's."""

    def __init__(self):
        self.ref, self.port = [], []

    def record_reference(self, impl):
        def wrapped(p, x, moe, *args, **kw):
            t = x.reshape(-1, x.shape[-1])
            logits = (t @ p["router"]).astype(jnp.float32)
            _, topi = lax.top_k(logits, moe.top_k)
            jax.debug.callback(
                lambda lg, ti: self.ref.append((np.asarray(lg),
                                                np.asarray(ti))),
                logits, topi, ordered=True)
            return impl(p, x, moe, *args, **kw)
        return wrapped

    def force(self, route):
        def forced(p, t, moe):
            logits, _, topi, _ = route(p, t, moe)
            ref_logits, ref_topi = self.ref[len(self.port)]
            self.port.append((logits.float().numpy(), topi.numpy()))
            ti = torch.tensor(ref_topi).long()
            tw = torch.softmax(torch.gather(logits, 1, ti), dim=-1)
            return logits, tw, ti, L._load_balance_loss(logits, ti, moe)
        return forced

    def assert_flips_are_near_ties(self):
        assert len(self.port) == len(self.ref)
        for (lp, tp), (lr, tr) in zip(self.port, self.ref):
            for i in np.flatnonzero((np.sort(tp, 1) != np.sort(tr, 1))
                                    .any(1)):
                k = tr.shape[1]
                ranked = np.sort(lr[i])[::-1]
                gap = ranked[k - 1] - ranked[k]
                assert gap <= 2 * np.abs(lp[i] - lr[i]).max(), (i, lr[i],
                                                                 lp[i])


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(port config, port bf16 params, batch, reference bf16 outputs and
    fp32 outputs, the routing recorded): ``forward``'s logits and aux,
    ``STEPS`` decode steps' logits over a bf16 cache, ``encode_memory``'s
    K/V where the stack has it."""
    ref_cfg = ref_configs.get_smoke_config(arch)
    p16 = RT.init_model(ref_cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    batch = _batch(ref_cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    routing = Routing()
    out = {}
    impls = dict(RL.MOE_IMPLS)
    for name, params in (("bf16", p16), ("fp32", _widen(p16))):
        if name == "bf16":
            RL.MOE_IMPLS["dense"] = routing.record_reference(impls["dense"])
        try:
            logits, aux = jax.jit(functools.partial(RT.forward, ref_cfg))(
                params, jb)
            cache = RT.init_cache(ref_cfg, B, CACHE,
                                  dtype=jnp.bfloat16 if name == "bf16"
                                  else jnp.float32)
            mem = None
            if ref_cfg.is_encoder_decoder:
                mem = RT.encode_memory(ref_cfg, params, jb)
                cache = dict(cache, cross_k=mem[0], cross_v=mem[1])
            step = jax.jit(functools.partial(RT.decode_step, ref_cfg))
            steps = []
            for t in range(STEPS):
                lg, cache = step(params, {"tokens": jb["tokens"][:, t:t + 1]},
                                 cache)
                steps.append(lg)
            jax.effects_barrier()
        finally:
            RL.MOE_IMPLS.update(impls)
        out[name] = dict(logits=logits, aux=aux, decode=steps, memory=mem)
    return (configs.get_smoke_config(arch),
            params_from_jax(jax.tree_util.tree_map(np.asarray, p16)),
            batch, out, routing)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _bound(out, key):
    want16, want32 = out["bf16"][key], out["fp32"][key]
    if isinstance(want16, list):
        return max(_bound({"bf16": {key: a}, "fp32": {key: b}}, key)
                   for a, b in zip(want16, want32))
    return 2 * float(np.abs(_np(want16) - _np(want32)).max())


def check_stack(arch, monkeypatch):
    """``forward``, then ``STEPS`` decode steps over a bf16 cache (after
    ``encode_memory`` for the encoder-decoder): the reference's dtypes,
    within twice the reference's own bf16 error, on its expert choices."""
    cfg, params, batch, out, routing = _reference(arch)
    routing.port.clear()
    monkeypatch.setattr(L, "_route", routing.force(L._route))
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = T.forward(cfg, params, tb)
        cache = T.init_cache(cfg, B, CACHE, dtype=torch.bfloat16)
        if cfg.is_encoder_decoder:
            ck, cv = T.encode_memory(cfg, params, tb)
            want_k = out["bf16"]["memory"][0]
            assert ck.dtype == torch.float32 == _dtype(want_k)
            # the fp32 frames promote the encoder to fp32 in both runs of
            # the reference, which then agree: the fp32 bound of
            # test_torch_families.py holds the port's
            np.testing.assert_allclose(_np(ck), _np(want_k), rtol=1e-5,
                                       atol=1e-5)
            cache["cross_k"], cache["cross_v"] = ck, cv
        steps = [T.decode_step(cfg, params,
                               {"tokens": tb["tokens"][:, t:t + 1]},
                               cache)[0] for t in range(STEPS)]
    want = out["bf16"]
    assert logits.dtype == torch.bfloat16 == _dtype(want["logits"])
    assert aux.dtype == torch.float32 == _dtype(want["aux"])
    err = float(np.abs(_np(logits) - _np(want["logits"])).max())
    assert err <= _bound(out, "logits"), (err, _bound(out, "logits"))
    # the load-balance loss, an fp32 mean over the routed tokens: within
    # the reference's bf16 rtol (test_kernels.py:21)
    np.testing.assert_allclose(float(aux), float(want["aux"]), rtol=2e-2,
                               atol=0)
    for got, w in zip(steps, want["decode"]):
        assert got.dtype == torch.bfloat16 == _dtype(w)
    err = max(float(np.abs(_np(g) - _np(w)).max())
              for g, w in zip(steps, want["decode"]))
    assert err <= _bound(out, "decode"), (err, _bound(out, "decode"))
    routing.assert_flips_are_near_ties()


def _dtype(x):
    return {jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.float32): torch.float32}[jnp.asarray(x).dtype]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_bf16_stack_matches_the_reference(arch, monkeypatch):
    check_stack(arch, monkeypatch)


def test_init_model_bf16_leaves_are_the_references():
    """``init_model(..., dtype=torch.bfloat16)`` gives the reference's leaf
    dtypes (Mamba-2's ``A_log``, ``D``, ``dt_bias`` in fp32), and a leaf
    drawn in fp32 and cast is the fp32 draw rounded."""
    for arch in ("jamba-1.5-large-398b", "seamless-m4t-medium"):
        params = params_from_jax(jax.tree_util.tree_map(
            np.asarray, RT.init_model(ref_configs.get_smoke_config(arch),
                                      jax.random.PRNGKey(0),
                                      dtype=jnp.bfloat16)))
        got = T.init_model(configs.get_smoke_config(arch),
                           torch.Generator().manual_seed(0),
                           dtype=torch.bfloat16)
        assert {k: v.dtype for k, v in got.items()} == {
            k: v.dtype for k, v in params.items()}
    cfg = configs.get_smoke_config("tinyllama-1.1b")
    g32 = T.init_model(cfg, torch.Generator().manual_seed(3))
    g16 = T.init_model(cfg, torch.Generator().manual_seed(3),
                       dtype=torch.bfloat16)
    assert all(torch.equal(g32[k].to(torch.bfloat16), g16[k]) for k in g32)
