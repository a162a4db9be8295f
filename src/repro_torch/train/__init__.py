"""Training utilities of the port: the optimizers (``optimizer``), the LM
train step (``train_step``), checkpointing (``checkpoint``) and metrics
logging (``metrics``)."""
from repro_torch.train.optimizer import (clip_by_global_norm, cosine_schedule,
                                         make_optimizer)
from repro_torch.train.train_step import (cross_entropy, make_loss_fn,
                                          make_train_step)
from repro_torch.train.checkpoint import (checkpoint_step, load_checkpoint,
                                          save_checkpoint)
from repro_torch.train.metrics import MetricsLogger

__all__ = ["make_optimizer", "cosine_schedule", "clip_by_global_norm",
           "make_train_step", "make_loss_fn", "cross_entropy",
           "save_checkpoint", "load_checkpoint", "checkpoint_step",
           "MetricsLogger"]
