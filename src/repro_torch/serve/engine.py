"""Batched serving engine: prefill + decode with the stack's cache (full
or ring-buffer KV for attention, SSD and conv state for Mamba-2, the
encoder's cross-attention K/V for an encoder-decoder).

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
from repro_torch.models.transformer import (ENC_MEMORY_LEN, decode_step,
                                            encode_memory, init_cache)
from repro_torch.serve import sampler as samplers


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor], *,
                 max_len: int = 512, window: Optional[int] = None,
                 moe_impl: str = "dense"):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.window = window if window is not None else cfg.sliding_window
        self.moe_impl = moe_impl
        self.device = params["embed"].device

    def new_cache(self, batch_size: int) -> Dict[str, torch.Tensor]:
        return init_cache(self.cfg, batch_size, self.max_len,
                          window=self.window, device=self.device)

    def step(self, cache, tokens: torch.Tensor):
        """Logits ``[B, 1, V]`` of one token a row (``[B, 1]``); ``cache``
        advances in place."""
        with torch.no_grad():
            logits, _ = decode_step(self.cfg, self.params,
                                    {"tokens": tokens}, cache,
                                    moe_impl=self.moe_impl)
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
                 temp: float = 1.0,
                 src_embeds: Optional[torch.Tensor] = None) -> np.ndarray:
        """Returns [B, num_tokens] generated ids (a host array).
        ``sampler="temperature"`` draws its noise from ``generator``. An
        encoder-decoder first encodes ``src_embeds`` ``[B, S_enc, d]``
        (zeros of ``ENC_MEMORY_LEN`` frames when not given) into the
        cache's cross-attention K/V."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B = prompts.shape[0]
        cache = self.new_cache(B)
        if self.cfg.is_encoder_decoder:
            if src_embeds is None:
                src_embeds = torch.zeros((B, ENC_MEMORY_LEN,
                                          self.cfg.d_model),
                                         device=self.device)
            with torch.no_grad():
                cache["cross_k"], cache["cross_v"] = encode_memory(
                    self.cfg, self.params,
                    {"src_embeds": torch.as_tensor(src_embeds,
                                                   device=self.device)},
                    moe_impl=self.moe_impl)
        cache, logits = self.prefill(cache, prompts)
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
