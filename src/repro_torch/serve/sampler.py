"""Token samplers for the serving engine.

``temperature`` draws as ``jax.random.categorical`` does: the argmax of
the logits plus standard Gumbel noise. The noise comes from a
``torch.Generator``, or is passed in (``gumbel``) so that a test can feed
the reference's draws.
"""
from __future__ import annotations

from typing import Optional

import torch


def greedy(logits):
    """The most likely token of each row (the lowest index on a tie)."""
    return torch.argmax(logits, dim=-1)


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device="cpu") -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, ``u`` uniform on [tiny,
    1) as ``jax.random.gumbel`` draws it."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def temperature(logits, generator: Optional[torch.Generator] = None,
                temp: float = 1.0, top_k: int = 0, *,
                gumbel: Optional[torch.Tensor] = None):
    """One token a row from ``softmax(logits / temp)``, restricted to the
    ``top_k`` largest logits when ``top_k`` is set (ties at the k-th value
    kept). ``gumbel``: the noise, ``[B, V]``; drawn from ``generator``
    when not given."""
    logits = logits.to(torch.float32) / max(temp, 1e-6)
    if top_k:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= cutoff, logits, -torch.inf)
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits + gumbel, dim=-1)
