"""Deterministic seeding: a sequence of fresh ``torch.Generator``s."""
from __future__ import annotations

import torch


class PRNGSequence:
    """Hands out fresh generators, each seeded from a master generator
    seeded ``seed``, so the n-th one is the same in every run. Host-side
    (init code, data generation), as the reference's key sequence is; the
    generators it hands out live on ``device``."""

    def __init__(self, seed: int, device="cpu"):
        self._master = torch.Generator().manual_seed(seed)
        self.device = device

    def __iter__(self):
        return self

    def __next__(self) -> torch.Generator:
        sub = int(torch.randint(0, 2 ** 62, (), generator=self._master))
        return torch.Generator(device=self.device).manual_seed(sub)

    def take(self, n: int):
        return [next(self) for _ in range(n)]
