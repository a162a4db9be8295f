"""The LM stacks (the port of ``repro.models.transformer``), all six
families of the reference behind one functional API:

  dense   pre-norm GQA transformer decoder (llama / qwen style)
  moe     dense + mixture-of-experts MLPs (mixtral, granite)
  ssm     Mamba2 / SSD stack (attention-free)
  hybrid  jamba-style attention:mamba interleave with periodic MoE
  encdec  encoder-decoder with cross-attention (seamless backbone)
  vlm     dense decoder over stubbed image-patch embeddings (phi-3-vision)

``init_model`` draws the parameters, ``forward`` runs a full sequence
(train / prefill) and returns ``(logits, aux)`` (aux: the MoE layers'
load-balance loss, 0 without them), ``init_cache`` makes the decode cache,
``encode_memory`` the encoder-decoder's cross-attention K/V, and
``decode_step`` runs one token.

Parameters are one flat dict with the reference's ``/``-joined tree paths
as names: ``embed``, ``final_norm``, ``lm_head`` (untied only) and the
layer-stacked leaves of ``blocks/…`` (a homogeneous stack; ``blocks/attn/wq``
is ``[L, d, H·D]``), ``groups/pos{j}/…`` (the hybrid: position j of each
period, ``[L / period, ...]``) or ``encoder/…``, ``decoder/…`` (with
``decoder/cross/…``), ``enc_in_proj`` and ``enc_final_norm``.
``repro_torch.utils.trees.params_from_jax`` turns the reference's nested
dict into this form. The layers run in a Python loop where the reference
``lax.scan``s. Self-attention goes through ``ops.attention`` (the
``flash_attention`` kernel on the card), as the reference's TPU path does;
cross-attention runs ``layers.blockwise_attention`` on every device, as in
the reference.

``init_model(..., dtype=torch.bfloat16)`` builds a bf16 model, as the
reference's ``init_model(cfg, key, dtype=jnp.bfloat16)`` does: the stacks
then return the reference's dtypes (bf16 logits, fp32 aux), the kernels run
their bf16 instances, and mixed types promote as in ``jnp``
(``layers.mm``): an encoder-decoder's fp32 ``src_embeds`` make its encoder
and cross-attention K/V fp32. A cache of either float type serves a model
of either: a decode step writes its k, v (and conv state) in the cache's
dtype.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding.ctx import constrain

# Fixed encoder-memory length used by decode shapes of encoder-decoder archs.
ENC_MEMORY_LEN = 1024


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_plan(cfg: ModelConfig):
    """Static per-layer ``(mixer, mlp)`` plan for one stack."""
    plan = []
    for i in range(cfg.num_layers):
        if cfg.family == "ssm":
            mixer = "mamba"
        elif cfg.attn_period:
            mixer = ("attn" if (i % cfg.attn_period) == cfg.attn_period - 1
                     else "mamba")
        else:
            mixer = "attn"
        if cfg.family == "ssm":
            mlp = "none"
        elif cfg.moe is not None and (
                cfg.moe_period == 0
                or (i % cfg.moe_period) == cfg.moe_period - 1):
            mlp = "moe"
        elif cfg.d_ff:
            mlp = "dense"
        else:
            mlp = "none"
        plan.append((mixer, mlp))
    return plan


def _homogeneous(cfg: ModelConfig) -> bool:
    plan = _layer_plan(cfg)
    return all(p == plan[0] for p in plan)


def _init_block(generator, cfg: ModelConfig, device, n: int, *, mixer: str,
                mlp: str, cross: bool = False,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``n`` stacked blocks ``{ln1, attn|mamba, ln_cross?, cross?, ln2?,
    mlp|moe?}``, names relative to the block."""
    d = cfg.d_model

    def ones():
        return torch.ones((n, d), dtype=dtype, device=device)

    p = {"ln1": ones()}
    if mixer == "attn":
        p.update({f"attn/{k}": v for k, v in
                  L.init_attention(generator, cfg, device, n, dtype).items()})
    else:
        p.update({f"mamba/{k}": v for k, v in
                  L.init_mamba2(generator, cfg, device, n, dtype).items()})
    if cross:
        p["ln_cross"] = ones()
        p.update({f"cross/{k}": v for k, v in
                  L.init_attention(generator, cfg, device, n, dtype).items()})
    if mlp == "dense":
        p["ln2"] = ones()
        p.update({f"mlp/{k}": v for k, v in
                  L.init_mlp(generator, d, cfg.d_ff, device, n,
                             dtype).items()})
    elif mlp == "moe":
        p["ln2"] = ones()
        p.update({f"moe/{k}": v for k, v in
                  L.init_moe(generator, d, cfg.moe, device, n,
                             dtype).items()})
    return p


def _prefixed(prefix: str, tree: Dict[str, torch.Tensor]):
    return {f"{prefix}/{k}": v for k, v in tree.items()}


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device="cpu", dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The reference's shapes and scales, drawn from ``generator`` in fp32
    and cast to ``dtype`` leaf by leaf (Mamba-2's ``A_log``, ``D`` and
    ``dt_bias`` stay fp32, as in the reference)."""
    d = cfg.d_model
    params = {
        "embed": torch.randn((cfg.vocab_size, d), generator=generator,
                             device=device).mul_(0.02).to(dtype),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(generator, (d, cfg.vocab_size),
                                         device, dtype=dtype)
    plan = _layer_plan(cfg)
    if cfg.is_encoder_decoder:
        mlp = "moe" if cfg.moe else "dense"
        n = cfg.num_layers
        params.update(_prefixed("encoder", _init_block(
            generator, cfg, device, n, mixer="attn", mlp=mlp, dtype=dtype)))
        params["enc_final_norm"] = torch.ones((d,), dtype=dtype,
                                              device=device)
        params.update(_prefixed("decoder", _init_block(
            generator, cfg, device, n, mixer="attn", mlp=mlp, cross=True,
            dtype=dtype)))
        if cfg.continuous_encoder_input:
            params["enc_in_proj"] = L.init_dense(generator, (d, d), device,
                                                 dtype=dtype)
    elif _homogeneous(cfg):
        mixer, mlp = plan[0]
        params.update(_prefixed("blocks", _init_block(
            generator, cfg, device, cfg.num_layers, mixer=mixer, mlp=mlp,
            dtype=dtype)))
    else:
        # hybrid: one stack per position in the period
        period = cfg.attn_period
        n_groups = cfg.num_layers // period
        for j in range(period):
            mixer, mlp = plan[j]
            params.update(_prefixed(f"groups/pos{j}", _init_block(
                generator, cfg, device, n_groups, mixer=mixer, mlp=mlp,
                dtype=dtype)))
    return params


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------


def _block_apply(p, x, cfg: ModelConfig, *, mixer: str, mlp: str,
                 causal: bool = True, window=None, positions=None,
                 memory=None, moe_impl: str = "dense", q_chunk: int = 512,
                 kv_chunk: int = 1024):
    """One pre-norm block over ``x [B, S, d]`` (``p``: one layer's leaves,
    names relative to the block). Returns ``(x, aux)``."""
    aux = torch.zeros((), device=x.device)
    B, S = x.shape[:2]
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if mixer == "attn":
        q, k, v = L.attention_qkv(L.sub(p, "attn"), h, cfg)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        out = ops.attention(q, k, v, causal=causal, window=window)
        x = x + L.mm(out.reshape(B, S, -1), p["attn/wo"])
    else:
        x = x + L.mamba2_apply(L.sub(p, "mamba"), h, cfg)
    if memory is not None and "cross/wq" in p:
        h = L.rmsnorm(x, p["ln_cross"], cfg.norm_eps)
        q, k, v = L.attention_qkv(L.sub(p, "cross"), h, cfg, kv_x=memory)
        out = L.blockwise_attention(q, k, v, causal=False, q_chunk=q_chunk,
                                    kv_chunk=kv_chunk)
        x = x + L.mm(out.reshape(B, S, -1), p["cross/wo"])
    if mlp == "dense":
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(L.sub(p, "mlp"), h)
    elif mlp == "moe":
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        out, a = L.MOE_IMPLS[moe_impl](L.sub(p, "moe"), h, cfg.moe)
        x = x + out
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _unembed(cfg: ModelConfig, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.mm(x, head)


def _layers(stacked: Dict[str, torch.Tensor]):
    """One ``{name: tensor}`` a layer of a layer-stacked dict. ``unbind``,
    not ``v[i]``: its backward stacks the layers' gradients once, where
    each ``v[i]``'s would add a whole ``[L, ...]`` zero tensor."""
    split = {k: v.unbind(0) for k, v in stacked.items()}
    n = len(next(iter(split.values())))
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _run(body, lp, x, remat: bool):
    """``body(lp, x) -> (x, aux)``, its activations recomputed in the
    backward pass under ``remat`` (the reference's ``jax.checkpoint``)."""
    if remat:
        return checkpoint(body, lp, x, use_reentrant=False)
    return body(lp, x)


def _run_stack(stacked, x, body, remat: bool):
    """``body`` over every layer of a layer-stacked dict: ``(x, Σ aux)``."""
    aux = torch.zeros((), device=x.device)
    for lp in _layers(stacked):
        x, a = _run(body, lp, x, remat)
        aux = aux + a
    return x, aux


def forward(cfg: ModelConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *, moe_impl: str = "dense",
            q_chunk: int = 512, kv_chunk: int = 1024, remat: bool = False):
    """``(logits [B, S, V], aux)`` of ``batch["tokens"]`` (``[B, S]``
    integer). A VLM's ``batch["image_embeds"]`` ``[B, n_img, d]`` replace
    the first ``n_img`` token embeddings; an encoder-decoder reads
    ``batch["src_embeds"]`` (or ``src_tokens``). ``moe_impl`` names the MoE
    layers' implementation (``layers.MOE_IMPLS``); ``q_chunk``/``kv_chunk``
    tile the cross-attention; ``remat`` recomputes each block's activations
    in the backward pass (``torch.utils.checkpoint`` per block)."""
    if cfg.is_encoder_decoder:
        return _forward_encdec(cfg, params, batch, moe_impl=moe_impl,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               remat=remat)
    tokens = batch["tokens"].long()
    S = tokens.shape[1]
    x = constrain(params["embed"][tokens], "act")
    if cfg.family == "vlm" and "image_embeds" in batch:
        img = batch["image_embeds"].to(x.dtype)
        x = torch.cat([img, x[:, img.shape[1]:]], dim=1)
    positions = torch.arange(S, device=x.device)

    def make_body(mixer, mlp):
        def body(lp, x):
            x, aux = _block_apply(lp, x, cfg, mixer=mixer, mlp=mlp,
                                  causal=True, window=cfg.sliding_window,
                                  positions=positions, moe_impl=moe_impl,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk)
            return constrain(x, "act"), aux
        return body

    plan = _layer_plan(cfg)
    blocks = L.sub(params, "blocks")
    if blocks:
        x, aux = _run_stack(blocks, x, make_body(*plan[0]), remat)
    else:
        period = cfg.attn_period
        bodies = [make_body(*plan[j]) for j in range(period)]
        stacks = [_layers(L.sub(params, f"groups/pos{j}"))
                  for j in range(period)]
        aux = torch.zeros((), device=x.device)
        for g in range(cfg.num_layers // period):
            group_aux = torch.zeros((), device=x.device)
            for j in range(period):
                x, a = _run(bodies[j], stacks[j][g], x, remat)
                group_aux = group_aux + a
            aux = aux + group_aux
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return constrain(_unembed(cfg, params, x), "logits"), aux


def _encoder_input(cfg: ModelConfig, params, batch):
    if cfg.continuous_encoder_input:
        return L.mm(batch["src_embeds"], params["enc_in_proj"])
    return params["embed"][batch["src_tokens"].long()]


def _encode(cfg: ModelConfig, params, batch, *, moe_impl, q_chunk, kv_chunk,
            remat: bool = False):
    """The encoder stack (non-causal self-attention): ``(memory [B, Ss,
    d], aux)``, memory after ``enc_final_norm``."""
    mlp = "moe" if cfg.moe else "dense"
    enc_x = _encoder_input(cfg, params, batch)
    enc_pos = torch.arange(enc_x.shape[1], device=enc_x.device)

    def enc_body(lp, x):
        x, aux = _block_apply(lp, x, cfg, mixer="attn", mlp=mlp,
                              causal=False, positions=enc_pos,
                              moe_impl=moe_impl, q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
        return constrain(x, "act"), aux

    memory, aux = _run_stack(L.sub(params, "encoder"), enc_x, enc_body,
                             remat)
    return L.rmsnorm(memory, params["enc_final_norm"], cfg.norm_eps), aux


def _forward_encdec(cfg: ModelConfig, params, batch, *, moe_impl, q_chunk,
                    kv_chunk, remat):
    mlp = "moe" if cfg.moe else "dense"
    memory, aux_e = _encode(cfg, params, batch, moe_impl=moe_impl,
                            q_chunk=q_chunk, kv_chunk=kv_chunk, remat=remat)
    tokens = batch["tokens"].long()
    dec_x = params["embed"][tokens]
    dec_pos = torch.arange(tokens.shape[1], device=dec_x.device)

    def dec_body(lp, x):
        x, aux = _block_apply(lp, x, cfg, mixer="attn", mlp=mlp,
                              causal=True, positions=dec_pos, memory=memory,
                              moe_impl=moe_impl, q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
        return constrain(x, "act"), aux

    x, aux_d = _run_stack(L.sub(params, "decoder"), dec_x, dec_body, remat)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return constrain(_unembed(cfg, params, x), "logits"), aux_e + aux_d


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------


def _attn_cache(prefix, n, B, C, cfg: ModelConfig, dtype, device):
    shape = (n, B, C, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {f"{prefix}/k": torch.zeros(shape, dtype=dtype, device=device),
            f"{prefix}/v": torch.zeros(shape, dtype=dtype, device=device),
            f"{prefix}/k_pos": torch.full((n, C), -1, dtype=torch.int64,
                                          device=device)}


def _ssm_cache(lead, B, cfg: ModelConfig, dtype, device):
    s = cfg.ssm
    _, n_heads, conv_ch = L.mamba2_split_dims(cfg)
    return {"ssm/ssm_state": torch.zeros(
                lead + (B, n_heads, s.head_dim, s.d_state),
                dtype=torch.float32, device=device),
            "ssm/conv_state": torch.zeros(
                lead + (B, s.conv_width - 1, conv_ch), dtype=dtype,
                device=device)}


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               dtype=torch.float32, window: Optional[int] = None,
               device="cpu") -> Dict[str, torch.Tensor]:
    """The decode cache, a flat dict on ``device``: ``pos`` (the next
    token's position, a 0-d integer tensor) and, layer-stacked:

    - an attention stack's ``attn/k``, ``attn/v`` ``[L, B, C, K, D]`` with
      ``attn/k_pos`` ``[L, C]`` (-1 marks an empty slot);
    - an ssm stack's ``ssm/ssm_state`` ``[L, B, H, P, N]`` and
      ``ssm/conv_state`` ``[L, B, W-1, conv_ch]``;
    - a hybrid's ``attn/…`` over its ``L / period`` attention layers and
      ``ssm/…`` ``[L / period, period - 1, ...]``;
    - an encoder-decoder's ``self/…`` (as ``attn/…``) and ``cross_k``,
      ``cross_v`` ``[L, B, ENC_MEMORY_LEN, K, D]`` (``encode_memory``
      gives their values).

    ``window`` (if set) makes the attention cache a ring buffer of ``C =
    min(cache_len, window)`` slots."""
    n, B = cfg.num_layers, batch_size
    C = min(cache_len, window) if window else cache_len
    cache = {"pos": torch.zeros((), dtype=torch.int64, device=device)}
    if cfg.is_encoder_decoder:
        cache.update(_attn_cache("self", n, B, C, cfg, dtype, device))
        shape = (n, B, ENC_MEMORY_LEN, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    elif cfg.family == "ssm":
        cache.update(_ssm_cache((n,), B, cfg, dtype, device))
    elif cfg.attn_period:
        period = cfg.attn_period
        n_groups = n // period
        cache.update(_attn_cache("attn", n_groups, B, C, cfg, dtype, device))
        cache.update(_ssm_cache((n_groups, period - 1), B, cfg, dtype,
                                device))
    else:
        cache.update(_attn_cache("attn", n, B, C, cfg, dtype, device))
    return cache


def encode_memory(cfg: ModelConfig, params, batch, *, moe_impl: str = "dense",
                  q_chunk: int = 512, kv_chunk: int = 1024):
    """Run the encoder and precompute each decoder layer's cross-attention
    K/V: ``(cross_k, cross_v)`` ``[L, B, S_enc, K, D]``, for the decode
    cache of an encoder-decoder."""
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: encode_memory needs an "
                         "encoder-decoder")
    memory, _ = _encode(cfg, params, batch, moe_impl=moe_impl,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
    hd = cfg.resolved_head_dim
    B, Ss = memory.shape[:2]
    ks, vs = [], []
    for lp in _layers(L.sub(params, "decoder")):
        h = L.rmsnorm(memory, lp["ln_cross"], cfg.norm_eps)
        k = L.mm(h, lp["cross/wk"])
        v = L.mm(h, lp["cross/wv"])
        if "cross/bk" in lp:
            k = k + lp["cross/bk"]
            v = v + lp["cross/bv"]
        ks.append(k.reshape(B, Ss, cfg.num_kv_heads, hd))
        vs.append(v.reshape(B, Ss, cfg.num_kv_heads, hd))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------


def _attn_decode(p, h, cfg: ModelConfig, k_cache, v_cache, k_pos, pos,
                 window):
    """One-token attention with the ring-buffer write: the new k, v go to
    slot ``pos mod C`` of this layer's ``k_cache``/``v_cache`` ``[B, C, K,
    D]`` (in the cache's dtype) and ``k_pos`` ``[C]`` (in place). h: [B, 1,
    d]."""
    B, C = h.shape[0], k_cache.shape[1]
    q, k, v = L.attention_qkv(p, h, cfg)
    pos_b = pos.expand(B)
    q = L.apply_rope(q, pos_b[:, None], cfg.rope_theta)
    k = L.apply_rope(k, pos_b[:, None], cfg.rope_theta)
    slot = torch.remainder(pos, C).reshape(1)
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    k_pos.index_copy_(0, slot, pos.reshape(1))
    out = L.full_attention_1q(q, k_cache, v_cache, k_pos.expand(B, C),
                              pos_b, window=window,
                              kv_valid=(k_pos >= 0).expand(B, C))
    return L.mm(out.reshape(B, 1, -1), p["wo"])


def _cross_decode(p, h, cfg: ModelConfig, ck, cv):
    """One token's cross-attention against the fixed encoder K/V ``ck``,
    ``cv`` ``[B, S_enc, K, D]``. h: [B, 1, d]."""
    B, Sm = h.shape[0], ck.shape[1]
    q = L.mm(h, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, 1, cfg.num_heads, cfg.resolved_head_dim)
    mem_pos = torch.arange(Sm, device=h.device).expand(B, Sm)
    big = torch.full((B,), 2 ** 30, dtype=torch.int64, device=h.device)
    out = L.full_attention_1q(q, ck, cv, mem_pos, big)
    return L.mm(out.reshape(B, 1, -1), p["wo"])


def _mlp_decode(lp, x, cfg: ModelConfig, moe_impl: str):
    if "mlp/w_up" in lp:
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(L.sub(lp, "mlp"), h)
    elif "moe/router" in lp:
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        out, _ = L.MOE_IMPLS[moe_impl](L.sub(lp, "moe"), h, cfg.moe)
        x = x + out
    return x


def _decode_layers(cfg: ModelConfig, params, cache):
    """Each decoder layer in order: ``(lp, state)``, where ``state`` is the
    layer's cache views: ``(k, v, k_pos)`` for an attention layer,
    ``(ssm_state, conv_state)`` for a Mamba-2 layer."""
    if cfg.is_encoder_decoder:
        names = ("self/k", "self/v", "self/k_pos")
        for i, lp in enumerate(_layers(L.sub(params, "decoder"))):
            yield lp, tuple(cache[n][i] for n in names)
        return
    attn = ("attn/k", "attn/v", "attn/k_pos")
    ssm = ("ssm/ssm_state", "ssm/conv_state")
    blocks = L.sub(params, "blocks")
    if blocks:
        names = ssm if cfg.family == "ssm" else attn
        for i, lp in enumerate(_layers(blocks)):
            yield lp, tuple(cache[n][i] for n in names)
        return
    period = cfg.attn_period
    plan = _layer_plan(cfg)
    stacks = [_layers(L.sub(params, f"groups/pos{j}")) for j in range(period)]
    for g in range(cfg.num_layers // period):
        mamba_i = 0
        for j in range(period):
            if plan[j][0] == "attn":
                yield stacks[j][g], tuple(cache[n][g] for n in attn)
            else:
                yield stacks[j][g], tuple(cache[n][g, mamba_i] for n in ssm)
                mamba_i += 1


def decode_step(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor], *, moe_impl: str = "dense"):
    """One decode step. ``batch["tokens"]``: [B, 1]. Returns ``(logits [B,
    1, V], cache)``: the cache is updated in place (its slots, states and
    ``pos``) and returned."""
    pos = cache["pos"]
    x = params["embed"][batch["tokens"].long()]             # [B, 1, d]
    for i, (lp, state) in enumerate(_decode_layers(cfg, params, cache)):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if "attn/wq" in lp:
            x = x + _attn_decode(L.sub(lp, "attn"), h, cfg, *state, pos,
                                 cfg.sliding_window)
        else:
            ssm, conv = state
            y, ssm_i, conv_i = L.mamba2_decode(L.sub(lp, "mamba"), h[:, 0],
                                               cfg, ssm, conv)
            ssm.copy_(ssm_i)
            conv.copy_(conv_i)
            x = x + y[:, None]
        if cfg.is_encoder_decoder:
            h = L.rmsnorm(x, lp["ln_cross"], cfg.norm_eps)
            x = x + _cross_decode(L.sub(lp, "cross"), h, cfg,
                                  cache["cross_k"][i], cache["cross_v"][i])
        x = _mlp_decode(lp, x, cfg, moe_impl)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    pos.add_(1)
    return _unembed(cfg, params, x), cache
