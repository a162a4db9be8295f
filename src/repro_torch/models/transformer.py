"""The decoder stacks of the federated LM (a subset of
``repro.models.transformer``): homogeneous ``dense`` (pre-norm GQA
attention + SwiGLU MLP) and ``ssm`` (Mamba-2) stacks, full-sequence
forward only.

Parameters are one flat dict with the reference's ``/``-joined tree paths
as names: ``embed``, ``final_norm``, ``lm_head`` (untied only) and the
layer-stacked ``blocks/…`` leaves (``blocks/attn/wq`` is ``[L, d, H·D]``);
``repro_torch.utils.trees.params_from_jax`` turns the reference's nested
dict into this form. The layers run in a Python loop over the stack, where
the reference ``lax.scan``s.
"""
from __future__ import annotations

from typing import Dict

import torch

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


def forward(cfg: ModelConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits ``[B, S, V]`` of ``batch["tokens"]`` (``[B, S]`` integer).
    The reference also returns an MoE auxiliary loss, which a dense or ssm
    stack does not have."""
    mixer, mlp = layer_kind(cfg)
    tokens = batch["tokens"].long()
    S = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(S, device=x.device)
    blocks = L.sub(params, "blocks")
    for i in range(cfg.num_layers):
        x = _block_apply({k: v[i] for k, v in blocks.items()}, x, cfg,
                         mixer=mixer, mlp=mlp, window=cfg.sliding_window,
                         positions=positions)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head
