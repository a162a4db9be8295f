"""Batched serving engine: prefill + decode with the stack's cache (full
or ring-buffer KV for attention, SSD and conv state for Mamba-2).

``generate`` drives one-token ``decode_step`` calls; prefill feeds the
prompt through ``decode_step`` token by token, as the reference does
(right for every family, ring buffers included). Everything runs on the
device the parameters live on, with autograd off.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import decode_step, init_cache
from repro_torch.serve import sampler as samplers


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor], *,
                 max_len: int = 512, window: Optional[int] = None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.window = window if window is not None else cfg.sliding_window
        self.device = params["embed"].device

    def new_cache(self, batch_size: int) -> Dict[str, torch.Tensor]:
        return init_cache(self.cfg, batch_size, self.max_len,
                          window=self.window, device=self.device)

    def step(self, cache, tokens: torch.Tensor):
        """Logits ``[B, 1, V]`` of one token a row (``[B, 1]``); ``cache``
        advances in place."""
        with torch.no_grad():
            logits, _ = decode_step(self.cfg, self.params,
                                    {"tokens": tokens}, cache)
        return logits

    def prefill(self, cache, prompts: torch.Tensor):
        """prompts: [B, S_prompt] — fed through decode steps; returns
        (cache, last_logits)."""
        logits = None
        for t in range(prompts.shape[1]):
            logits = self.step(cache, prompts[:, t:t + 1])
        return cache, logits

    def generate(self, prompts: torch.Tensor, num_tokens: int, *,
                 sampler: str = "greedy",
                 generator: Optional[torch.Generator] = None,
                 temp: float = 1.0) -> np.ndarray:
        """Returns [B, num_tokens] generated ids (a host array).
        ``sampler="temperature"`` draws its noise from ``generator``."""
        prompts = torch.as_tensor(prompts, device=self.device)
        cache, logits = self.prefill(self.new_cache(prompts.shape[0]),
                                     prompts)
        out = []
        tok = self._sample(logits[:, -1], sampler, generator, temp)
        out.append(tok)
        for _ in range(1, num_tokens):
            logits = self.step(cache, tok[:, None])
            tok = self._sample(logits[:, -1], sampler, generator, temp)
            out.append(tok)
        return torch.stack(out, dim=1).cpu().numpy()

    @staticmethod
    def _sample(logits, sampler, generator, temp):
        if sampler == "greedy":
            return samplers.greedy(logits)
        return samplers.temperature(logits, generator, temp)
