"""Beyond-paper: uplink update compression, coupled into the paper's
spectrum allocator (``repro.core.compression``).

The paper treats the uplink payload z_n as a constant (448 KB fp32 CNN).
Compressing client updates shrinks z_n, which enters SAO through
H_n = z_n·p_n and t_com = z_n/r_n. Schemes:

  int8      : per-leaf symmetric quantization (8 bits + fp32 scale/leaf)
  topk:<f>  : magnitude top-k sparsification, keep fraction f
              (values fp32 + index log2(n) bits each)

Both quantize then dequantize the real updates, so the accuracy cost is
measured, not assumed. Given a tensor, each compresses one block as ONE
tensor — a leaf's ``[S_pad, size]`` columns of a round's rows, padding
rows included, as the reference does — or, with ``lanes=True``, each
slice along the leading (cohort lane) axis on its own: one scale or
threshold a lane, never across lanes. Given a tree (a dict of tensors,
the reference's form), each compresses every floating leaf as one block
and leaves the others as they are; a tensor takes the same code as
before, so a block caller's bits do not depend on the tree form.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch


def _tree(fn, tree):
    return {k: fn(v) if v.is_floating_point() else v for k, v in tree.items()}


def _flat(block: torch.Tensor, lanes: bool) -> torch.Tensor:
    return block.reshape(block.shape[0], -1) if lanes else block.reshape(1, -1)


def compress_int8(block, lanes: bool = False):
    """Symmetric int8 quantize → dequantize: scale = max|x| / 127 (at
    least 1e-12 / 127), round half to even, clip to ±127; fp32 out. A
    tree: every floating leaf on its own scale."""
    if isinstance(block, Mapping):
        return _tree(compress_int8, block)
    a = _flat(block.to(torch.float32), lanes)
    amax = torch.amax(torch.abs(a), dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return (q.to(torch.float32) * scale).reshape(block.shape)


def compress_topk(block, fraction: float, lanes: bool = False):
    """Keep the entries whose magnitude reaches the k-th largest, k =
    ⌈fraction·n⌉ (at least 1) of the block's n entries; zero the rest
    (ties at the threshold are all kept); in the block's dtype. A tree:
    every floating leaf on its own threshold."""
    if isinstance(block, Mapping):
        return _tree(lambda leaf: compress_topk(leaf, fraction), block)
    a = _flat(block.to(torch.float32), lanes)
    k = max(int(math.ceil(fraction * a.shape[1])), 1)
    mag = torch.abs(a)
    thresh = torch.topk(mag, k, dim=1).values[:, -1:]
    kept = torch.where(mag >= thresh, a, torch.zeros_like(a))
    return kept.reshape(block.shape).to(block.dtype)


def apply_compression(tree, scheme: str):
    """``scheme`` (``None``/``"none"``, ``"int8"``, ``"topk:<f>"``) on a
    tree or a block; any other scheme raises ``ValueError``."""
    if scheme in (None, "none"):
        return tree
    if scheme == "int8":
        return compress_int8(tree)
    if scheme.startswith("topk:"):
        return compress_topk(tree, float(scheme.split(":")[1]))
    raise ValueError(scheme)


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
