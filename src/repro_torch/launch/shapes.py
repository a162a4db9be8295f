"""Stand-ins and specs for every (arch × input shape) (the port of
``repro.launch.shapes``).

A struct is a tensor on ``torch.device("meta")``: it has a shape and a
dtype and no storage, so a 398 B-parameter model costs no memory, and a
step run on structs (``repro_torch.roofline.analysis.analyze_step``)
computes shapes only. ``batch_structs`` and ``cache_structs`` return
``(structs, specs)``: ``PartitionSpec``s under the rules of
``repro_torch.sharding.specs``, where the reference returns
``NamedSharding``s.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import (LONG_CONTEXT_WINDOW, InputShape,
                                      ModelConfig)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import init_cache, init_model
from repro_torch.sharding import specs as sh

META = torch.device("meta")


def struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def decode_window(cfg: ModelConfig, shape: InputShape):
    """The SWA ring-buffer window used for long_500k on full-attention
    families (mixtral's native window is kept as-is)."""
    if shape.name == "long_500k" and cfg.num_heads and cfg.attn_period == 0:
        return cfg.sliding_window or LONG_CONTEXT_WINDOW
    return cfg.sliding_window


def batch_structs(cfg: ModelConfig, shape: InputShape, mesh: Mesh,
                  dtype=torch.bfloat16) -> Tuple[Dict[str, torch.Tensor],
                                                 Dict[str, sh.PartitionSpec]]:
    """(structs, specs) for the step function's ``batch`` argument."""
    B, S = shape.global_batch, shape.seq_len
    tok = sh.token_spec(mesh, B)
    emb3 = sh.token_spec(mesh, B, extra_dims=2)
    if shape.is_decode:
        return {"tokens": struct((B, 1), torch.int32)}, {"tokens": tok}
    structs = {"tokens": struct((B, S), torch.int32)}
    specs = {"tokens": tok}
    if cfg.family == "vlm":
        structs["image_embeds"] = struct((B, cfg.num_image_tokens,
                                          cfg.d_model), dtype)
        specs["image_embeds"] = emb3
    if cfg.is_encoder_decoder:
        structs["src_embeds"] = struct((B, S, cfg.d_model), dtype)
        specs["src_embeds"] = emb3
    return structs, specs


def param_structs(cfg: ModelConfig, dtype=torch.bfloat16
                  ) -> Dict[str, torch.Tensor]:
    """``init_model``'s parameters on ``meta``: the port's flat dict of
    the reference's tree paths, shapes and dtypes."""
    return init_model(cfg, torch.Generator(), device=META, dtype=dtype)


def cache_structs(cfg: ModelConfig, shape: InputShape, mesh: Mesh,
                  dtype=torch.bfloat16):
    """``init_cache``'s decode cache on ``meta`` (the long_500k window
    applied) and its specs."""
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, dtype=dtype,
                       window=decode_window(cfg, shape), device=META)
    shards = sh.cache_shardings(cfg, cache, mesh, shape.global_batch)
    return cache, {k: s.spec for k, s in shards.items()}
