"""The layers the LM's forward pass and its decode step run (a subset of
``repro.models.layers``): norms, RoPE, GQA projections, the SwiGLU MLP,
the Mamba-2 block, (re-exported under the reference's name) the chunked
SSD form ``kernels.ssd_chunked.ssd_chunked``, and the one-token decode
pieces (``full_attention_1q``, ``ssd_decode_step``,
``causal_conv1d_step``, ``mamba2_decode``), plain tensor code as in the
reference, which reaches no kernel on decode.

Parameters are flat ``{name: tensor}`` dicts of one layer's subtree
(``{"wq", "wk", "wv", "wo"}`` for attention), with the reference's layouts:
``[d_in, d_out]`` projections, ``[B, S, H, D]`` heads. ``init_*`` draw from a
``torch.Generator`` with the reference's shapes and scales (the numbers
differ from ``jax.random``'s). The sequence mixers go through
``repro_torch.kernels.ops``: the CUDA kernels for a tensor on the card,
their plain versions on the CPU.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_chunked import ssd_chunked  # noqa: F401

NEG_INF = -1e30


def sub(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The ``prefix/…`` leaves of a flat dict, with the prefix stripped."""
    cut = len(prefix) + 1
    return {k[cut:]: v for k, v in params.items()
            if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------


def init_dense(generator, shape, device, scale=None) -> torch.Tensor:
    """Normal weights of ``shape`` (``[..., d_in, d_out]``) scaled by
    ``scale`` (default 1/sqrt(d_in))."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32) * scale


def rmsnorm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight


def silu(x):
    return x * torch.sigmoid(x)


def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [B, S, H, D]; positions: [B, S] or [S]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs   # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(generator, cfg: ModelConfig, device, layers: int):
    """``layers`` stacked attention blocks: ``{name: [layers, ...]}``."""
    hd = cfg.resolved_head_dim
    L, d = layers, cfg.d_model
    p = {
        "wq": init_dense(generator, (L, d, cfg.num_heads * hd), device),
        "wk": init_dense(generator, (L, d, cfg.num_kv_heads * hd), device),
        "wv": init_dense(generator, (L, d, cfg.num_kv_heads * hd), device),
        "wo": init_dense(generator, (L, cfg.num_heads * hd, d), device,
                         scale=1.0 / math.sqrt(cfg.num_heads * hd)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros((L, width * hd), device=device)
    return p


def full_attention_1q(q, k, v, k_positions, q_position, *, window=None,
                      kv_valid=None):
    """Single-query decode attention over a (possibly ring-buffer) cache.

    q: [B, 1, H, D]; k/v: [B, C, K, D]; k_positions: [B, C] absolute
    positions; q_position: [B] absolute position of the new token;
    kv_valid: [B, C] (optional) marks the filled slots."""
    B, _, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, D).to(torch.float32) / math.sqrt(D)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.float32))
    kp, qp = k_positions[:, None, None, :], q_position[:, None, None, None]
    mask = kp <= qp
    if window is not None:
        mask = mask & ((qp - kp) < window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.to(torch.float32))
    return out.reshape(B, 1, H, D).to(q.dtype)


def attention_qkv(p, x, cfg: ModelConfig):
    """Project hidden states ``[B, S, d]`` to q ``[B, S, H, D]`` and k, v
    ``[B, S, K, D]``."""
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    B, S = x.shape[:2]
    return (q.reshape(B, S, cfg.num_heads, hd),
            k.reshape(B, S, cfg.num_kv_heads, hd),
            v.reshape(B, S, cfg.num_kv_heads, hd))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(generator, d_model: int, d_ff: int, device, layers: int):
    L = layers
    return {
        "w_gate": init_dense(generator, (L, d_model, d_ff), device),
        "w_up": init_dense(generator, (L, d_model, d_ff), device),
        "w_down": init_dense(generator, (L, d_ff, d_model), device,
                             scale=1.0 / math.sqrt(d_ff)),
    }


def mlp_apply(p, x):
    return (silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------


def mamba2_split_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


def init_mamba2(generator, cfg: ModelConfig, device, layers: int):
    s = cfg.ssm
    L = layers
    d_inner, n_heads, conv_ch = mamba2_split_dims(cfg)
    u = torch.rand((L, n_heads), generator=generator, device=device,
                   dtype=torch.float32)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    inv_softplus_dt = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": init_dense(generator, (L, cfg.d_model, 2 * d_inner
                                          + 2 * s.n_groups * s.d_state
                                          + n_heads), device),
        "conv_w": init_dense(generator, (L, s.conv_width, conv_ch), device,
                             scale=1.0 / math.sqrt(s.conv_width)),
        "conv_b": torch.zeros((L, conv_ch), device=device),
        "A_log": a_log.expand(L, n_heads).clone(),
        "D": torch.ones((L, n_heads), device=device),
        "dt_bias": inv_softplus_dt,
        "norm": torch.ones((L, d_inner), device=device),
        "out_proj": init_dense(generator, (L, d_inner, cfg.d_model), device,
                               scale=1.0 / math.sqrt(d_inner)),
    }


def causal_conv1d(x, w, b):
    """Depthwise causal conv. x: [B, S, C]; w: [W, C]; b: [C]:
    ``out[t] = Σ_i w[i]·x[t − W + 1 + i]`` with zeros before the start."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def causal_conv1d_step(x_t, conv_state, w, b):
    """One decode step of the depthwise conv. x_t: [B, C]; conv_state:
    [B, W-1, C] (the previous inputs). Returns (y_t [B, C], new state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # [B,W,C]
    y = (torch.einsum("bwc,wc->bc", window.to(torch.float32),
                      w.to(torch.float32)) + b.to(torch.float32))
    return y.to(x_t.dtype), window[:, 1:]


def ssd_decode_step(x, dt, A_raw, Bm, Cm, D, state):
    """Single-token SSD recurrence. x: [B, H, P]; dt: [B, H]; A_raw: [H]
    (negative); Bm, Cm: [B, G, N]; state: [B, H, P, N]. Returns (y [B, H,
    P], new_state)."""
    rep = x.shape[1] // Bm.shape[1]
    Bh = torch.repeat_interleave(Bm, rep, dim=1)                 # [B,H,N]
    Ch = torch.repeat_interleave(Cm, rep, dim=1)
    dA = torch.exp(dt * A_raw[None, :])                          # [B,H]
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, x)
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y + D[None, :, None] * x, new_state


def mamba2_apply(p, x, cfg: ModelConfig):
    """Mamba2 block over a full sequence. x: [B, S, D] -> [B, S, D]. The
    SSD recurrence is ``ops.ssd`` (the ``ssd_scan`` kernel on the card)."""
    s = cfg.ssm
    d_inner, n_heads, conv_ch = mamba2_split_dims(cfg)
    B, S, _ = x.shape
    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = torch.split(zxbcdt, [d_inner, conv_ch, n_heads], dim=-1)
    xBC = silu(causal_conv1d(xBC, p["conv_w"], p["conv_b"]))
    gn = s.n_groups * s.d_state
    xs, Bm, Cm = torch.split(xBC, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(B, S, n_heads, s.head_dim)
    Bm = Bm.reshape(B, S, s.n_groups, s.d_state)
    Cm = Cm.reshape(B, S, s.n_groups, s.d_state)
    dt = torch.nn.functional.softplus(dt.to(torch.float32) + p["dt_bias"])
    A_raw = -torch.exp(p["A_log"])                                  # [H]
    Xdt = xs.to(torch.float32) * dt[..., None]
    Y, _ = ops.ssd(Xdt, dt * A_raw, Bm.to(torch.float32),
                   Cm.to(torch.float32), chunk=s.chunk_size,
                   n_groups=s.n_groups)
    Y = Y + p["D"][None, None, :, None] * xs.to(torch.float32)
    Y = Y.reshape(B, S, d_inner).to(x.dtype)
    Y = rmsnorm(Y * silu(z), p["norm"], cfg.norm_eps)
    return Y @ p["out_proj"]


def mamba2_decode(p, x_t, cfg: ModelConfig, ssm_state, conv_state):
    """One decode step of the Mamba2 block. x_t: [B, D]. Returns (y_t [B,
    D], ssm_state, conv_state)."""
    s = cfg.ssm
    d_inner, n_heads, conv_ch = mamba2_split_dims(cfg)
    B = x_t.shape[0]
    zxbcdt = x_t @ p["in_proj"]
    z, xBC, dt = torch.split(zxbcdt, [d_inner, conv_ch, n_heads], dim=-1)
    xBC, conv_state = causal_conv1d_step(xBC, conv_state, p["conv_w"],
                                         p["conv_b"])
    xBC = silu(xBC)
    gn = s.n_groups * s.d_state
    xs, Bm, Cm = torch.split(xBC, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(B, n_heads, s.head_dim).to(torch.float32)
    Bm = Bm.reshape(B, s.n_groups, s.d_state).to(torch.float32)
    Cm = Cm.reshape(B, s.n_groups, s.d_state).to(torch.float32)
    dt = torch.nn.functional.softplus(dt.to(torch.float32) + p["dt_bias"])
    A_raw = -torch.exp(p["A_log"])
    y, ssm_state = ssd_decode_step(xs, dt, A_raw, Bm, Cm, p["D"], ssm_state)
    y = y.reshape(B, d_inner).to(x_t.dtype)
    y = rmsnorm(y * silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], ssm_state, conv_state
