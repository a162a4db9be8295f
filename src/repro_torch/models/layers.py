"""The layers of the LM stacks (the port of ``repro.models.layers``):
norms, RoPE, GQA projections (with cross-attention's ``kv_x``), the
reference's off-TPU ``blockwise_attention`` (the encoder-decoder's
cross-attention), the SwiGLU MLP, the three MoE implementations
(``MOE_IMPLS``), the Mamba-2 block, (re-exported under the reference's
name) the chunked SSD form ``kernels.ssd_chunked.ssd_chunked``, and the
one-token decode pieces (``full_attention_1q``, ``ssd_decode_step``,
``causal_conv1d_step``, ``mamba2_decode``). Blockwise attention, the MoE
layers and the decode pieces are plain tensor code on every device, as
in the reference, which reaches no Pallas kernel there.

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

from repro_torch.configs.base import ModelConfig, MoEConfig
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


def attention_qkv(p, x, cfg: ModelConfig, kv_x=None):
    """Project hidden states ``[B, S, d]`` to q ``[B, S, H, D]`` and k, v
    ``[B, Skv, K, D]``; k and v from ``kv_x`` ``[B, Skv, d]`` where given
    (cross-attention), else from ``x``."""
    hd = cfg.resolved_head_dim
    kv_src = x if kv_x is None else kv_x
    q = x @ p["wq"]
    k = kv_src @ p["wk"]
    v = kv_src @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    B, S = x.shape[:2]
    skv = kv_src.shape[1]
    return (q.reshape(B, S, cfg.num_heads, hd),
            k.reshape(B, skv, cfg.num_kv_heads, hd),
            v.reshape(B, skv, cfg.num_kv_heads, hd))


def _attn_block(q_blk, k_blk, q_pos, k_pos, causal, window, kv_valid):
    """The masked logits ``[B, K, G, Tq, Tk]`` of one (q chunk × kv chunk)
    tile. q_blk: [B, Tq, K, G, D] (scaled); k_blk: [B, Tk, K, D]."""
    logits = torch.einsum("btkgd,bskd->bkgts", q_blk.to(torch.float32),
                          k_blk.to(torch.float32))
    mask = torch.ones(logits.shape[-2:], dtype=torch.bool,
                      device=logits.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    if kv_valid is not None:
        mask = mask & kv_valid[None, :]
    return torch.where(mask, logits, NEG_INF)


def blockwise_attention(q, k, v, *, causal: bool = True, window=None,
                        q_positions=None, k_positions=None, kv_valid=None,
                        q_chunk: int = 512, kv_chunk: int = 1024):
    """Memory-efficient attention, the reference's off-TPU form: online
    softmax over kv chunks for each q chunk, so the ``[Sq, Sk]`` score
    matrix never exists whole. Plain tensor code on every device (the
    reference computes it outside any Pallas kernel); the encoder-decoder's
    cross-attention runs it.

    q: [B, Sq, H, D]; k, v: [B, Sk, K, D] with H % K == 0 (GQA).
    Positions default to aligned ranges; ``kv_valid`` [Sk] marks the keys
    that count. Sq and Sk are padded up to whole chunks (padded queries at
    position -1, padded keys invalid). Output: [B, Sq, H, D]."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if k_positions is None:
        k_positions = torch.arange(Sk, device=dev)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    pad_q = nq * q_chunk - Sq
    pad_k = nk * kv_chunk - Sk
    qg = q.reshape(B, Sq, K, G, D) * (1.0 / math.sqrt(D))
    pad = torch.nn.functional.pad
    if pad_q:
        qg = pad(qg, (0, 0, 0, 0, 0, 0, 0, pad_q))
        q_positions = pad(q_positions, (0, pad_q), value=-1)
    if pad_k:
        k = pad(k, (0, 0, 0, 0, 0, pad_k))
        v = pad(v, (0, 0, 0, 0, 0, pad_k))
        k_positions = pad(k_positions, (0, pad_k), value=2 ** 30)
        if kv_valid is None:
            kv_valid = torch.arange(nk * kv_chunk, device=dev) < Sk
        else:
            kv_valid = pad(kv_valid, (0, pad_k), value=False)

    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        q_blk, q_pos = qg[:, qs], q_positions[qs]
        m = torch.full((B, K, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, K, G, q_chunk), device=dev)
        acc = torch.zeros((B, q_chunk, K, G, D), device=dev)
        for j in range(nk):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            logits = _attn_block(q_blk, k[:, ks], q_pos, k_positions[ks],
                                 causal, window,
                                 None if kv_valid is None else kv_valid[ks])
            new_m = torch.maximum(m, logits.amax(dim=-1))
            correction = torch.exp(m - new_m)
            # fully masked tiles: keep probs exactly 0 (no exp(-inf - -inf))
            probs = torch.where(logits > NEG_INF * 0.5,
                                torch.exp(logits - new_m[..., None]), 0.0)
            l = l * correction + probs.sum(dim=-1)
            pv = torch.einsum("bkgts,bskd->btkgd", probs,
                              v[:, ks].to(torch.float32))
            acc = acc * correction.permute(0, 3, 1, 2)[..., None] + pv
            m = new_m
        denom = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(acc / denom)
    out = torch.cat(outs, dim=1).reshape(B, nq * q_chunk, H, D)
    return out[:, :Sq].to(q.dtype)


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
# Mixture of Experts (plain tensor code on every device: the reference has
# no MoE kernel)
# ---------------------------------------------------------------------------


def init_moe(generator, d_model: int, moe: MoEConfig, device, layers: int):
    """``layers`` stacked MoE MLPs: the router ``[L, d, E]`` (scale 0.02)
    and the experts' SwiGLU ``w_gate``/``w_up`` ``[L, E, d, F]``,
    ``w_down`` ``[L, E, F, d]``."""
    L, E, F = layers, moe.num_experts, moe.d_ff
    return {
        "router": init_dense(generator, (L, d_model, E), device, scale=0.02),
        "w_gate": init_dense(generator, (L, E, d_model, F), device),
        "w_up": init_dense(generator, (L, E, d_model, F), device),
        "w_down": init_dense(generator, (L, E, F, d_model), device,
                             scale=1.0 / math.sqrt(F)),
    }


def _route(p, t, moe: MoEConfig):
    """Router logits ``[T, E]`` (fp32) of tokens ``t`` ``[T, d]``, their
    top-k ``(softmaxed weights, experts)`` ``[T, k]`` — descending, the
    lower expert first on ties, as ``lax.top_k`` ranks — and the
    load-balance loss."""
    from repro_torch.strategies.traced import _stable_top
    logits = (t @ p["router"]).to(torch.float32)
    topw, topi = _stable_top(logits, moe.top_k)
    return (logits, torch.softmax(topw, dim=-1), topi,
            _load_balance_loss(logits, topi, moe))


def _gates(logits, topw, topi):
    """The dense ``[T, E]`` gate matrix: ``topw`` at the chosen experts."""
    return torch.zeros_like(logits).scatter(1, topi, topw)


def moe_apply_dense(p, x, moe: MoEConfig):
    """Every expert on every token, combined with the sparse top-k router
    weights (E/k times the useful flops). Returns ``(out [B, S, d],
    aux)``."""
    B, S, D = x.shape
    t = x.reshape(B * S, D)
    logits, topw, topi, aux = _route(p, t, moe)
    gates = _gates(logits, topw, topi)
    h = torch.einsum("td,edf->tef", t, p["w_gate"])
    u = torch.einsum("td,edf->tef", t, p["w_up"])
    y = torch.einsum("tef,efd->ted", silu(h) * u, p["w_down"])
    out = torch.einsum("te,ted->td", gates.to(y.dtype), y)
    return out.reshape(B, S, D), aux


def moe_apply_dense_fused(p, x, moe: MoEConfig):
    """:func:`moe_apply_dense` with the gate applied to the hidden
    activations before the down projection, so (e, f) contract in one
    product. Returns ``(out [B, S, d], aux)``."""
    B, S, D = x.shape
    t = x.reshape(B * S, D)
    logits, topw, topi, aux = _route(p, t, moe)
    gates = _gates(logits, topw, topi)
    h = torch.einsum("td,edf->tef", t, p["w_gate"])
    u = torch.einsum("td,edf->tef", t, p["w_up"])
    hu = (silu(h) * u) * gates.to(h.dtype)[:, :, None]
    out = torch.einsum("tef,efd->td", hu, p["w_down"])
    return out.reshape(B, S, D), aux


def moe_capacity(tokens: int, moe: MoEConfig,
                 capacity_factor: float = 1.25) -> int:
    """Slots an expert takes in :func:`moe_apply_dispatch`."""
    return max(int(capacity_factor * tokens * moe.top_k / moe.num_experts), 1)


def dispatch_slots(topi, num_experts: int, cap: int):
    """Where each (token, slot) pair of ``topi`` ``[T, k]`` goes: the pairs
    sorted by expert, stably (so the same pairs are dropped as by the
    reference's ``jnp.argsort``), and each pair's ``rank`` within its
    expert. Returns ``(order, expert, rank, keep)`` in sorted order;
    ``keep`` is ``rank < cap``."""
    n = topi.numel()
    expert_flat = topi.reshape(n)
    order = torch.argsort(expert_flat, stable=True)
    e_sorted = expert_flat[order]
    seg_start = torch.searchsorted(e_sorted, e_sorted, side="left")
    rank = torch.arange(n, device=topi.device) - seg_start
    return order, e_sorted, rank, rank < cap


def moe_apply_dispatch(p, x, moe: MoEConfig, capacity_factor: float = 1.25):
    """Sort-based capacity dispatch: the (token, slot) pairs sorted by
    expert fill ``[E, C, d]`` buffers (``C`` = :func:`moe_capacity`), each
    expert runs on its buffer, and each token sums its k results. Pairs
    past an expert's capacity are dropped (the residual passes). Every
    buffer slot takes at most one pair and the k results of a token are
    summed in slot order (the sort inverted, then a sum over k), not by an
    atomic scatter-add, so two calls give the same bits on every device.
    Returns ``(out [B, S, d], aux)``."""
    B, S, D = x.shape
    T = B * S
    E, K = moe.num_experts, moe.top_k
    cap = moe_capacity(T, moe, capacity_factor)
    t = x.reshape(T, D)
    _, topw, topi, aux = _route(p, t, moe)
    order, e_sorted, rank, keep = dispatch_slots(topi, E, cap)
    tok_sorted = order // K
    gate_sorted = topw.reshape(T * K)[order]

    # one slot a kept pair; the dropped pairs write zeros to a spare slot
    slot = torch.where(keep, e_sorted * cap + rank, E * cap)
    vals = torch.where(keep[:, None], t[tok_sorted].to(torch.float32), 0.0)
    buf = torch.zeros((E * cap + 1, D), dtype=torch.float32, device=x.device)
    buf = buf.index_put((slot,), vals)[:E * cap].reshape(E, cap, D)

    h = torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(torch.float32))
    u = torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(torch.float32))
    ye = torch.einsum("ecf,efd->ecd", silu(h) * u,
                      p["w_down"].to(torch.float32)).reshape(E * cap, D)

    # back to (token, slot) order, then each token's k results in turn
    contrib = torch.where(keep[:, None],
                          ye[torch.clamp(slot, max=E * cap - 1)]
                          * gate_sorted[:, None], 0.0)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(T * K, device=x.device)
    out = contrib[inverse].reshape(T, K, D).sum(dim=1)
    return out.to(x.dtype).reshape(B, S, D), aux


def _load_balance_loss(router_logits, topi, moe: MoEConfig):
    """Switch-transformer load-balance auxiliary loss."""
    probs = torch.softmax(router_logits, dim=-1)                 # [T, E]
    E = moe.num_experts
    frac_tokens = torch.nn.functional.one_hot(
        topi[:, 0], E).to(torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return moe.load_balance_coef * E * torch.sum(frac_tokens * frac_probs)


MOE_IMPLS = {"dense": moe_apply_dense, "dispatch": moe_apply_dispatch,
             "dense_fused": moe_apply_dense_fused}


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
