"""Model registry — the seam between the round engine and the model.

A federated workload is a :class:`ModelDef`: the shapes and initial values
of one client's trainable state, the per-client local losses of a stacked
batch, and the evaluation on the held-out set. The engine dispatches on the
type of the frozen model config: ``CNNConfig`` (the paper CNN) or
``LMConfig`` (LoRA adapters over a frozen LM). Spec-side, a workload name
(``ExperimentSpec.model``) resolves to a config through
:func:`workload_config`; ``"auto"``/``"cnn"`` stay on the paper-CNN path
in ``build_experiment``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.models import lm
from repro_torch.models.cnn import (cnn_forward, cnn_loss_stacked,
                                   cnn_param_shapes, init_cnn)


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """``shapes(cfg)`` -> ``{name: shape}``;
    ``init(cfg, generator, device)`` -> ``{name: tensor}``;
    ``loss(stacked_params, images, labels, cfg[, base=])`` -> per-client
    mean loss ``[S]``; ``evaluate(params, test_x, test_y, cfg=cfg[,
    base=])`` -> ``(accuracy, per_class)`` tensors.
    ``base(cfg, device)`` (optional) gives the frozen weights that ride
    outside the plane, passed to ``loss``/``evaluate`` as ``base=``.
    ``price_uploads``: price the fleet's upload ``z`` at the trainable
    parameter count (``P·32`` bits) instead of the paper CNN's default.
    ``make_dataset(cfg, num_samples, seed=)`` (optional): the workload
    builds its own data; ``None`` rides ``ExperimentSpec.dataset``."""
    name: str
    shapes: Callable
    init: Callable
    loss: Callable
    evaluate: Callable
    base: Optional[Callable] = None
    price_uploads: bool = False
    make_dataset: Any = None


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

LORA_LM_DEF = ModelDef(name="lora-lm", shapes=lm.adapter_shapes,
                       init=lm.init_adapter, loss=lm.lm_loss_stacked,
                       evaluate=lm.lm_evaluate, base=lm.base_params,
                       price_uploads=True, make_dataset=lm.lm_make_dataset)

_DEFS = {CNNConfig: CNN_DEF, lm.LMConfig: LORA_LM_DEF}

_WORKLOADS = {
    "tinyllama": lambda: lm.LMConfig(
        model=get_smoke_config("tinyllama-1.1b")),
    "mamba2-130m": lambda: lm.LMConfig(
        model=get_smoke_config("mamba2-130m")),
}


def register_workload(name: str, builder: Callable[[], Any]) -> None:
    """Bind an ``ExperimentSpec.model`` name to a config builder (an
    ``LMConfig`` over a published width, say)."""
    _WORKLOADS[name] = builder


def model_def_for(model_cfg) -> ModelDef:
    """The :class:`ModelDef` for a config object."""
    mdef = _DEFS.get(type(model_cfg))
    if mdef is None:
        raise TypeError(f"no ModelDef for config type "
                        f"{type(model_cfg).__name__}; the port runs "
                        "CNNConfig and LMConfig")
    return mdef


def workload_names() -> Tuple[str, ...]:
    """The registered non-CNN workload names."""
    return tuple(sorted(_WORKLOADS))


def workload_config(name: str):
    """Resolve an ``ExperimentSpec.model`` name to its frozen config."""
    if name not in _WORKLOADS:
        raise ValueError(f"unknown model {name!r}; known: "
                         f"{('auto', 'cnn') + workload_names()}")
    return _WORKLOADS[name]()
