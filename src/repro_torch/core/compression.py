"""Beyond-paper: uplink update compression, coupled into the paper's
spectrum allocator (``repro.core.compression``).

The paper treats the uplink payload z_n as a constant (448 KB fp32 CNN).
Compressing client updates shrinks z_n, which enters SAO through
H_n = z_n·p_n and t_com = z_n/r_n. Schemes:

  int8      : per-leaf symmetric quantization (8 bits + fp32 scale/leaf)
  topk:<f>  : magnitude top-k sparsification, keep fraction f
              (values fp32 + index log2(n) bits each)

Both quantize then dequantize the real updates, so the accuracy cost is
measured, not assumed. Each compresses one block as ONE tensor — a
leaf's ``[S_pad, size]`` columns of a round's rows, padding rows included,
as the reference does — or, with ``lanes=True``, each slice along the
leading (cohort lane) axis on its own: one scale or threshold a lane,
never across lanes.
"""
from __future__ import annotations

import math

import torch


def _flat(block: torch.Tensor, lanes: bool) -> torch.Tensor:
    return block.reshape(block.shape[0], -1) if lanes else block.reshape(1, -1)


def compress_int8(block: torch.Tensor, lanes: bool = False) -> torch.Tensor:
    """Symmetric int8 quantize → dequantize: scale = max|x| / 127 (at
    least 1e-12 / 127), round half to even, clip to ±127."""
    a = _flat(block.to(torch.float32), lanes)
    amax = torch.amax(torch.abs(a), dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return (q.to(torch.float32) * scale).reshape(block.shape)


def compress_topk(block: torch.Tensor, fraction: float,
                  lanes: bool = False) -> torch.Tensor:
    """Keep the entries whose magnitude reaches the k-th largest, k =
    ⌈fraction·n⌉ (at least 1) of the block's n entries; zero the rest
    (ties at the threshold are all kept)."""
    a = _flat(block.to(torch.float32), lanes)
    k = max(int(math.ceil(fraction * a.shape[1])), 1)
    mag = torch.abs(a)
    thresh = torch.topk(mag, k, dim=1).values[:, -1:]
    kept = torch.where(mag >= thresh, a, torch.zeros_like(a))
    return kept.reshape(block.shape).to(block.dtype)


def payload_mbit(num_params: int, scheme: str, num_leaves: int = 8) -> float:
    """Uplink payload for one client update under ``scheme`` (z_n in
    Mbit)."""
    if scheme in (None, "none"):
        bits = 32.0 * num_params
    elif scheme == "int8":
        bits = 8.0 * num_params + 32.0 * num_leaves
    elif scheme.startswith("topk:"):
        f = float(scheme.split(":")[1])
        k = max(int(math.ceil(f * num_params)), 1)
        idx_bits = max(math.ceil(math.log2(max(num_params, 2))), 1)
        bits = k * (32.0 + idx_bits)
    else:
        raise ValueError(scheme)
    return bits / 1e6
