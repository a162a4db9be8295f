"""Training utilities of the port: checkpointing (``checkpoint``)."""
from repro_torch.train.checkpoint import (checkpoint_step, load_checkpoint,
                                          save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_step"]
