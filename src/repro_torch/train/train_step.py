"""Train-step factory: next-token cross entropy + optimizer update, the
gradient by autograd (the reference's ``jax.value_and_grad``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.transformer import forward
from repro_torch.train.optimizer import make_optimizer


def cross_entropy(logits, targets, mask=None, label_smoothing: float = 0.0):
    """logits: [B, S, V]; targets: [B, S] int. Mean NLL over valid tokens
    (``mask`` marks them), mixed with the mean over the vocabulary at
    ``label_smoothing``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = -torch.mean(logp, dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def make_loss_fn(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """``loss_fn(params, batch) -> (loss, {"ce", "aux"})``: next-token
    cross entropy over ``batch["tokens"]`` (or against ``batch["labels"]``
    where given), with ``batch["loss_mask"]`` if present. A dense or ssm
    stack has no auxiliary loss (``aux`` is 0)."""
    def loss_fn(params, batch: Dict[str, Any]):
        logits = forward(model_cfg, params, batch, remat=train_cfg.remat)
        aux = torch.zeros((), device=logits.device)
        targets = batch.get("labels")
        mask = batch.get("loss_mask")
        if targets is None:
            logits = logits[:, :-1]
            targets = batch["tokens"][:, 1:]
            mask = mask[:, 1:] if mask is not None else None
        ce = cross_entropy(logits, targets, mask, train_cfg.label_smoothing)
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """Returns (init_state_fn(params) -> opt_state, train_step fn).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics);
    the metrics are 0-d tensors on the parameters' device (no host read).
    """
    loss_fn = make_loss_fn(model_cfg, train_cfg)
    opt_init, opt_update = make_optimizer(train_cfg)

    def train_step(params, opt_state, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, parts = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        with torch.no_grad():
            params, opt_state, stats = opt_update(grads, opt_state, params)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **stats}
        return params, opt_state, metrics

    return opt_init, train_step
