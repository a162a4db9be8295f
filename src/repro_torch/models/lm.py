"""Federated LM workload: per-client LoRA adapters over a frozen
transformer (the port of ``repro.models.lm``).

The per-client trainable state is a LoRA adapter: layer-stacked low-rank
``A``/``B`` factors on the attention q/v projections (dense families) or the
Mamba2 in/out projections (ssm). The frozen base is drawn once per
``(LMConfig, device)`` from ``base_seed`` on a generator of its own and
lives outside the flat plane, so the ``[N, P]`` client plane holds only
``P = P_adapter`` columns and divergence, K-means, aggregation and upload
pricing work on adapter rows unchanged. The experiment gets the base from
its draws object (``TorchDraws.base_params``), so a parity test can hand in
the reference's.

``merge_lora`` materializes ``w_eff = w_base + (alpha/rank)·A@B`` on the
stacked block leaves and hands the merged dict to ``transformer.forward``.
Token windows ride the engine's ``images`` slot (``[..., seq_len+1]``
integers) and the window's dialect its ``labels`` slot; the loss reads only
the window.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.lm_data import make_lm_dataset
from repro_torch.models.transformer import forward, init_model


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Frozen, hashable config of one LoRA LM workload."""
    model: ModelConfig              # the frozen-base transformer architecture
    seq_len: int = 32               # tokens per training window
    rank: int = 4                   # LoRA rank r
    alpha: float = 8.0              # LoRA scaling (applied as alpha/rank)
    base_seed: int = 0              # seed the frozen base derives from
    num_dialects: int = 10          # synthetic dialects = "classes"


def _check_supported(m: ModelConfig) -> None:
    if m.is_encoder_decoder or m.attn_period or m.moe is not None:
        raise ValueError(
            f"{m.name}: LoRA FL workloads support homogeneous dense/ssm "
            "stacks only (no enc-dec / hybrid / MoE)")
    if m.family not in ("dense", "ssm", "vlm"):
        raise ValueError(f"{m.name}: unsupported family {m.family!r}")


def _group(cfg: LMConfig) -> str:
    return "mamba" if cfg.model.family == "ssm" else "attn"


def adapter_targets(cfg: LMConfig):
    """``name -> (d_in, d_out)`` of the frozen-base leaves LoRA wraps."""
    m = cfg.model
    _check_supported(m)
    if m.family == "ssm":
        s = m.ssm
        d_inner = s.expand * m.d_model
        n_heads = d_inner // s.head_dim
        return {"in_proj": (m.d_model,
                            2 * d_inner + 2 * s.n_groups * s.d_state + n_heads),
                "out_proj": (d_inner, m.d_model)}
    hd = m.resolved_head_dim
    return {"wq": (m.d_model, m.num_heads * hd),
            "wv": (m.d_model, m.num_kv_heads * hd)}


def adapter_shapes(cfg: LMConfig) -> Dict[str, tuple]:
    """``{name: shape}`` of one client's adapter: ``[L, d_in, r]`` A and
    ``[L, r, d_out]`` B factors under ``blocks/<group>/``."""
    n, r, grp = cfg.model.num_layers, cfg.rank, _group(cfg)
    out = {}
    for name, (d_in, d_out) in sorted(adapter_targets(cfg).items()):
        out[f"blocks/{grp}/{name}_a"] = (n, d_in, r)
        out[f"blocks/{grp}/{name}_b"] = (n, r, d_out)
    return out


def adapter_num_params(cfg: LMConfig) -> int:
    """P_adapter — the per-client upload size in parameters."""
    return sum(math.prod(s) for s in adapter_shapes(cfg).values())


def init_adapter(cfg: LMConfig, generator: torch.Generator,
                 device="cpu") -> Dict[str, torch.Tensor]:
    """One client's adapter: A factors normal scaled by 1/sqrt(d_in), B
    factors zero (a fresh adapter is an exact no-op on the base)."""
    out = {}
    for name, shape in adapter_shapes(cfg).items():
        if name.endswith("_a"):
            out[name] = torch.randn(shape, generator=generator, device=device,
                                    dtype=torch.float32) / math.sqrt(shape[1])
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out


@functools.lru_cache(maxsize=4)
def base_params(cfg: LMConfig,
                device=torch.device("cpu")) -> Dict[str, torch.Tensor]:
    """The frozen base for ``cfg`` on ``device``: drawn from ``base_seed``
    on a generator of its own, once per ``(cfg, device)``
    (``base_params.cache_clear()`` frees it)."""
    _check_supported(cfg.model)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.base_seed)
    with torch.no_grad():
        return init_model(cfg.model, gen, device)


def merge_lora(cfg: LMConfig, adapter, base):
    """``base + (alpha/rank)·A@B`` on the wrapped block leaves; every other
    leaf is the shared base tensor (no copy)."""
    scale = cfg.alpha / cfg.rank
    grp = _group(cfg)
    merged = dict(base)
    for name in adapter_targets(cfg):
        key = f"blocks/{grp}/{name}"
        merged[key] = base[key] + scale * torch.bmm(
            adapter[f"{key}_a"].to(torch.float32),
            adapter[f"{key}_b"].to(torch.float32))
    return merged


def _logits(cfg: LMConfig, adapter, base, tokens):
    logits, _ = forward(cfg.model, merge_lora(cfg, adapter, base),
                        {"tokens": tokens[:, :-1]})
    return logits


def lm_loss(adapter, tokens, cfg: LMConfig, base):
    """Next-token cross-entropy over the window shift; ``tokens`` is
    ``[B, seq_len+1]`` integer."""
    logp = torch.log_softmax(_logits(cfg, adapter, base, tokens)
                             .to(torch.float32), dim=-1)
    targets = tokens[:, 1:].long()
    return -torch.gather(logp, -1, targets[..., None])[..., 0].mean()


def lm_loss_stacked(stacked, windows, labels, cfg: LMConfig, *, base):
    """Per-client mean losses ``[S]`` of stacked adapters ``{name: [S,
    ...]}`` on their windows ``[S, B, seq_len+1]``; client s's adapter
    appears only in its own term (one forward per client)."""
    return torch.stack([
        lm_loss({k: v[s] for k, v in stacked.items()}, windows[s], cfg, base)
        for s in range(windows.shape[0])])


def lm_evaluate(adapter, test_windows, test_dialects, *, cfg: LMConfig,
                base):
    """``(next-token accuracy, per-dialect accuracy)`` tensors, the LM
    analogue of the CNN's ``(accuracy, per_class)``."""
    with torch.no_grad():
        pred = torch.argmax(_logits(cfg, adapter, base, test_windows), dim=-1)
    hit = (pred == test_windows[:, 1:].long()).to(torch.float32)
    window_acc = hit.mean(dim=-1)
    onehot = torch.nn.functional.one_hot(test_dialects.long(),
                                         cfg.num_dialects).to(torch.float32)
    per_class = ((onehot * window_acc[:, None]).sum(0)
                 / torch.clamp(onehot.sum(0), min=1.0))
    return window_acc.mean(), per_class


def lm_make_dataset(cfg: LMConfig, num_samples: int, seed: int = 0):
    return make_lm_dataset(num_samples, cfg.seq_len, cfg.model.vocab_size,
                           num_dialects=cfg.num_dialects, seed=seed)
