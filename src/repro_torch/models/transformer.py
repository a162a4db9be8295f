"""The decoder stacks of the LM (a subset of ``repro.models.transformer``):
homogeneous ``dense`` (pre-norm GQA attention + SwiGLU MLP) and ``ssm``
(Mamba-2) stacks, the full-sequence ``forward`` (train / prefill) and the
one-token ``decode_step`` over the cache ``init_cache`` makes.

Parameters are one flat dict with the reference's ``/``-joined tree paths
as names: ``embed``, ``final_norm``, ``lm_head`` (untied only) and the
layer-stacked ``blocks/…`` leaves (``blocks/attn/wq`` is ``[L, d, H·D]``);
``repro_torch.utils.trees.params_from_jax`` turns the reference's nested
dict into this form. The layers run in a Python loop over the stack, where
the reference ``lax.scan``s.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def layer_kind(cfg: ModelConfig):
    """``(mixer, mlp)`` of every layer of a homogeneous stack; raises for
    the stacks the port does not run (hybrid, encoder-decoder, MoE)."""
    if cfg.is_encoder_decoder or cfg.attn_period or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port runs homogeneous dense / ssm stacks only")
    if cfg.family == "ssm":
        return "mamba", "none"
    return "attn", ("dense" if cfg.d_ff else "none")


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device="cpu") -> Dict[str, torch.Tensor]:
    """The reference's shapes and scales, drawn from ``generator``."""
    mixer, mlp = layer_kind(cfg)
    n, d = cfg.num_layers, cfg.d_model
    params = {
        "embed": torch.randn((cfg.vocab_size, d), generator=generator,
                             device=device) * 0.02,
        "final_norm": torch.ones((d,), device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(generator, (d, cfg.vocab_size),
                                         device)
    blocks = {"ln1": torch.ones((n, d), device=device)}
    if mixer == "attn":
        blocks.update({f"attn/{k}": v for k, v in
                       L.init_attention(generator, cfg, device, n).items()})
    else:
        blocks.update({f"mamba/{k}": v for k, v in
                       L.init_mamba2(generator, cfg, device, n).items()})
    if mlp == "dense":
        blocks["ln2"] = torch.ones((n, d), device=device)
        blocks.update({f"mlp/{k}": v for k, v in
                       L.init_mlp(generator, d, cfg.d_ff, device, n).items()})
    params.update({f"blocks/{k}": v for k, v in blocks.items()})
    return params


def _block_apply(p, x, cfg: ModelConfig, *, mixer: str, mlp: str,
                 window, positions):
    """One pre-norm block over ``x [B, S, d]`` (``p``: one layer's leaves,
    names relative to the block)."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if mixer == "attn":
        q, k, v = L.attention_qkv(L.sub(p, "attn"), h, cfg)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        out = ops.attention(q, k, v, causal=True, window=window)
        B, S = x.shape[:2]
        x = x + out.reshape(B, S, -1) @ p["attn/wo"]
    else:
        x = x + L.mamba2_apply(L.sub(p, "mamba"), h, cfg)
    if mlp == "dense":
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(L.sub(p, "mlp"), h)
    return x


def _unembed(cfg: ModelConfig, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def forward(cfg: ModelConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *,
            remat: bool = False) -> torch.Tensor:
    """Logits ``[B, S, V]`` of ``batch["tokens"]`` (``[B, S]`` integer).
    The reference also returns an MoE auxiliary loss, which a dense or ssm
    stack does not have. ``remat`` recomputes each block's activations in
    the backward pass (``torch.utils.checkpoint`` per block, the
    reference's ``jax.checkpoint`` of its scanned body)."""
    mixer, mlp = layer_kind(cfg)
    tokens = batch["tokens"].long()
    S = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(S, device=x.device)
    blocks = L.sub(params, "blocks")

    def block(lp, x):
        return _block_apply(lp, x, cfg, mixer=mixer, mlp=mlp,
                            window=cfg.sliding_window, positions=positions)

    # unbind, not v[i]: its backward stacks the layers' gradients once,
    # where each v[i]'s would add a whole [L, ...] zero tensor
    layers = {k: v.unbind(0) for k, v in blocks.items()}
    for i in range(cfg.num_layers):
        lp = {k: v[i] for k, v in layers.items()}
        x = (checkpoint(block, lp, x, use_reentrant=False) if remat
             else block(lp, x))
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, x)


# ---------------------------------------------------------------------------
# KV / state caches and the decode step
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               dtype=torch.float32, window: Optional[int] = None,
               device="cpu") -> Dict[str, torch.Tensor]:
    """The decode cache, a flat dict on ``device``: ``pos`` (the next
    token's position, a 0-d integer tensor) and, layer-stacked, the
    attention stack's ``attn/k``, ``attn/v`` ``[L, B, C, K, D]`` with
    ``attn/k_pos`` ``[L, C]`` (-1 marks an empty slot), or the ssm
    stack's ``ssm/ssm_state`` ``[L, B, H, P, N]`` and ``ssm/conv_state``
    ``[L, B, W-1, conv_ch]``. ``window`` (if set) makes the attention
    cache a ring buffer of ``C = min(cache_len, window)`` slots."""
    mixer, _ = layer_kind(cfg)
    n, B = cfg.num_layers, batch_size
    C = min(cache_len, window) if window else cache_len
    cache = {"pos": torch.zeros((), dtype=torch.int64, device=device)}
    if mixer == "attn":
        shape = (n, B, C, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["attn/k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["attn/v"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["attn/k_pos"] = torch.full((n, C), -1, dtype=torch.int64,
                                         device=device)
    else:
        s = cfg.ssm
        _, n_heads, conv_ch = L.mamba2_split_dims(cfg)
        cache["ssm/ssm_state"] = torch.zeros(
            (n, B, n_heads, s.head_dim, s.d_state), dtype=torch.float32,
            device=device)
        cache["ssm/conv_state"] = torch.zeros(
            (n, B, s.conv_width - 1, conv_ch), dtype=dtype, device=device)
    return cache


def _attn_decode(p, h, cfg: ModelConfig, k_cache, v_cache, k_pos, pos,
                 window):
    """One-token attention with the ring-buffer write: the new k, v go to
    slot ``pos mod C`` of this layer's ``k_cache``/``v_cache`` ``[B, C, K,
    D]`` and ``k_pos`` ``[C]`` (in place). h: [B, 1, d]."""
    B, C = h.shape[0], k_cache.shape[1]
    q, k, v = L.attention_qkv(p, h, cfg)
    pos_b = pos.expand(B)
    q = L.apply_rope(q, pos_b[:, None], cfg.rope_theta)
    k = L.apply_rope(k, pos_b[:, None], cfg.rope_theta)
    slot = torch.remainder(pos, C).reshape(1)
    k_cache.index_copy_(1, slot, k)
    v_cache.index_copy_(1, slot, v)
    k_pos.index_copy_(0, slot, pos.reshape(1))
    out = L.full_attention_1q(q, k_cache, v_cache, k_pos.expand(B, C),
                              pos_b, window=window,
                              kv_valid=(k_pos >= 0).expand(B, C))
    return out.reshape(B, 1, -1) @ p["wo"]


def _mlp_decode(lp, x, cfg: ModelConfig):
    if "mlp/w_up" in lp:
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(L.sub(lp, "mlp"), h)
    return x


def decode_step(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor]):
    """One decode step. ``batch["tokens"]``: [B, 1]. Returns ``(logits [B,
    1, V], cache)``: the cache is updated in place (its slots, states and
    ``pos``) and returned."""
    mixer, _ = layer_kind(cfg)
    pos = cache["pos"]
    x = params["embed"][batch["tokens"].long()]             # [B, 1, d]
    blocks = L.sub(params, "blocks")
    for i in range(cfg.num_layers):
        lp = {k: v[i] for k, v in blocks.items()}
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if mixer == "attn":
            x = x + _attn_decode(L.sub(lp, "attn"), h, cfg,
                                 cache["attn/k"][i], cache["attn/v"][i],
                                 cache["attn/k_pos"][i], pos,
                                 cfg.sliding_window)
        else:
            ssm, conv = cache["ssm/ssm_state"], cache["ssm/conv_state"]
            y, ssm_i, conv_i = L.mamba2_decode(L.sub(lp, "mamba"), h[:, 0],
                                               cfg, ssm[i], conv[i])
            ssm[i].copy_(ssm_i)
            conv[i].copy_(conv_i)
            x = x + y[:, None]
        x = _mlp_decode(lp, x, cfg)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    pos.add_(1)
    return _unembed(cfg, params, x), cache
