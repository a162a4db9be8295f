"""Optimizers as plain functions over flat parameter dicts (the reference's
formulas, not ``torch.optim``): AdamW, SGD and momentum-SGD, with the
cosine learning-rate schedule and global-norm clipping.

Every number stays on the parameters' device: the step counter is a 0-d
tensor and the learning rate a tensor computed from it, so an update
reads nothing back to the host.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.utils.trees import tree_global_norm

Params = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor              # 0-d integer, updates taken so far
    m: Optional[Params]             # first moment (momentum buffer); None for sgd
    v: Optional[Params]             # second moment; adamw only


def cosine_schedule(cfg: TrainConfig) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """``lr(step)``: linear warm-up over ``warmup_steps``, then a cosine
    decay to 0 at ``total_steps``."""
    def lr(step):
        step = step.to(torch.float32)
        warm = cfg.learning_rate * (step + 1.0) / max(cfg.warmup_steps, 1)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * cfg.learning_rate * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < cfg.warmup_steps, warm, cos)
    return lr


def clip_by_global_norm(grads: Params, max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, the norm
    before)``. The fp32 scale promotes a bf16 gradient to fp32, as ``jnp``
    promotes it (torch would keep a 0-d scalar's product in bf16)."""
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
            for k, g in grads.items()}, norm


def make_optimizer(cfg: TrainConfig) -> Tuple[Callable, Callable]:
    """Returns (init(params) -> state, update(grads, state, params) ->
    (new_params, new_state, stats)). ``moment_dtype="bfloat16"`` keeps the
    moments in bf16 (the arithmetic in fp32)."""
    lr_fn = cosine_schedule(cfg)
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def init(params: Params) -> OptState:
        step = torch.zeros((), dtype=torch.int64,
                           device=next(iter(params.values())).device)

        def zeros():
            return {k: torch.zeros_like(p, dtype=mdt)
                    for k, p in params.items()}
        if cfg.optimizer == "adamw":
            return OptState(step, zeros(), zeros())
        if cfg.optimizer == "momentum":
            return OptState(step, zeros(), None)
        return OptState(step, None, None)

    def update(grads: Params, state: OptState, params: Params):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        lr = lr_fn(state.step)
        step = state.step + 1
        stats = {"lr": lr, "gnorm": gnorm}

        if cfg.optimizer == "adamw":
            t = step.to(torch.float32)
            bc1 = 1.0 - torch.pow(cfg.beta1, t)
            bc2 = 1.0 - torch.pow(cfg.beta2, t)
            new_p, new_m, new_v = {}, {}, {}
            for k, p in params.items():
                g32 = grads[k].to(torch.float32)
                m32 = (cfg.beta1 * state.m[k].to(torch.float32)
                       + (1.0 - cfg.beta1) * g32)
                v32 = (cfg.beta2 * state.v[k].to(torch.float32)
                       + (1.0 - cfg.beta2) * torch.square(g32))
                u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
                if p.is_floating_point():
                    u = u + cfg.weight_decay * p.to(torch.float32)
                new_p[k] = (p.to(torch.float32) - lr * u).to(p.dtype)
                new_m[k], new_v[k] = m32.to(mdt), v32.to(mdt)
            return new_p, OptState(step, new_m, new_v), stats

        if cfg.optimizer == "momentum":
            new_p, new_m = {}, {}
            for k, p in params.items():
                m = 0.9 * state.m[k] + grads[k].to(torch.float32)
                new_p[k] = (p.to(torch.float32) - lr * m).to(p.dtype)
                new_m[k] = m
            return new_p, OptState(step, new_m, None), stats

        # plain SGD
        new_p = {k: (p.to(torch.float32)
                     - lr * grads[k].to(torch.float32)).to(p.dtype)
                 for k, p in params.items()}
        return new_p, OptState(step, None, None), stats

    return init, update
