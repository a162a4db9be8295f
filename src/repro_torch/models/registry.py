"""Model registry — the seam between the round engine and the model.

A federated workload is a :class:`ModelDef`: how to initialise one client's
trainable state, compute the per-client local losses of a stacked batch,
and evaluate a model on the held-out set. The port registers the paper CNN
only; the engine dispatches on the type of the frozen model config.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.models.cnn import (cnn_forward, cnn_loss_stacked,
                                   cnn_param_shapes, init_cnn)


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """``shapes(cfg)`` -> ``{name: shape}``;
    ``init(cfg, generator, device)`` -> ``{name: tensor}``;
    ``loss(stacked_params, images, labels, cfg)`` -> per-client mean loss
    ``[S]``; ``evaluate(params, test_x, test_y, cfg=cfg)`` ->
    ``(accuracy, per_class)`` tensors."""
    name: str
    shapes: Callable
    init: Callable
    loss: Callable
    evaluate: Callable


def _cnn_evaluate(params, test_images, test_labels, *, cfg: CNNConfig):
    with torch.no_grad():
        pred = torch.argmax(cnn_forward(params, test_images, cfg), dim=-1)
    correct = (pred == test_labels).to(torch.float32)
    onehot = torch.nn.functional.one_hot(test_labels.long(),
                                         cfg.num_classes).to(torch.float32)
    per_class = ((correct[:, None] * onehot).sum(0)
                 / torch.clamp(onehot.sum(0), min=1.0))
    return correct.mean(), per_class


CNN_DEF = ModelDef(name="cnn", shapes=cnn_param_shapes, init=init_cnn,
                   loss=cnn_loss_stacked, evaluate=_cnn_evaluate)


def model_def_for(model_cfg) -> ModelDef:
    """The :class:`ModelDef` for a config object."""
    if isinstance(model_cfg, CNNConfig):
        return CNN_DEF
    raise TypeError(f"no ModelDef for config type {type(model_cfg).__name__}; "
                    "the port runs the paper CNN (CNNConfig) only")
