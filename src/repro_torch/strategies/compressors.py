"""Registered uplink-compression strategies
(``repro.strategies.compressors``). Compression shrinks the payload z_n,
which enters SAO through H_n = z_n·p_n and t_com = z_n/r_n, and is
simulated on the real updates (quantize → dequantize), so its accuracy
cost is measured.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.api.registry import COMPRESSORS, Strategy
from repro_torch.core.compression import (compress_int8, compress_topk,
                                          payload_mbit)


class _DeltaCompressor(Strategy):
    """Compress the client *updates* (row − global row), then add the
    global row back.

    ``apply_flat(rows, global_vec, spec)`` takes the round's ``[S_pad, P]``
    rows of the flat plane and the ``[P]`` global row, or a cohort's
    ``[B, S_pad, P]`` and ``[B, P]``: the quantizer sees each leaf's
    columns as one ``[S_pad, size]`` block (padding rows included, as the
    reference's), one block a lane."""

    identity = False
    traceable = True

    def compress(self, block: torch.Tensor, lanes: bool) -> torch.Tensor:
        raise NotImplementedError

    def apply_flat(self, rows, global_vec, spec):
        lanes = rows.dim() == 3
        deltas = rows - global_vec[..., None, :]
        blocks = [self.compress(deltas[..., spec.columns(n)], lanes)
                  for n in spec.names]
        return global_vec[..., None, :] + torch.cat(blocks, dim=-1)


@COMPRESSORS.register("none")
@dataclass(frozen=True)
class NoCompression(Strategy):
    """Full-precision uplink: updates and the fleet's own z_n untouched."""

    identity = True
    traceable = True

    def apply_flat(self, rows, global_vec, spec):
        return rows

    def payload_mbit(self, num_params: int,
                     num_leaves: int) -> Optional[float]:
        return None


@COMPRESSORS.register("int8")
@dataclass(frozen=True)
class Int8Compressor(_DeltaCompressor):
    """Per-leaf symmetric int8 quantization (8 bits + fp32 scale/leaf)."""

    def compress(self, block, lanes):
        return compress_int8(block, lanes)

    def payload_mbit(self, num_params: int, num_leaves: int) -> float:
        return payload_mbit(num_params, "int8", num_leaves)


@COMPRESSORS.register("topk")
@dataclass(frozen=True)
class TopKCompressor(_DeltaCompressor):
    """Magnitude top-k sparsification keeping ``fraction`` of the entries
    (values fp32 + log2(n)-bit indices). Spelled ``topk:<fraction>``."""

    fraction: float = 0.01

    def compress(self, block, lanes):
        return compress_topk(block, self.fraction, lanes)

    def payload_mbit(self, num_params: int, num_leaves: int) -> float:
        return payload_mbit(num_params, f"topk:{self.fraction}", num_leaves)
