"""The flat parameter plane: one model's named tensors as a length-``P`` row.

The FL round treats every client model as one Euclidean point, so N client
models live in a single ``[N, P]`` buffer and selection, K-means and
aggregation are row operations on it. A port row is the SAME vector as a
reference row: leaves are laid out in jax's pytree order for a flat dict,
which is sorted-key order (``b_c1, b_c2, b_fc1, b_fc2, w_c1, ...``), not
``nn.Module`` insertion order; each leaf is reshaped row-major.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class StackFlattenSpec:
    """Static layout of one model's named tensors inside a flat row.

    Leaf ``i`` occupies columns ``[offsets[i], offsets[i] + sizes[i])``.
    """
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    total: int                         # P = sum(sizes)

    def columns(self, name: str) -> slice:
        """Column slice of leaf ``name`` (a zero-copy feature view)."""
        i = self.names.index(name)
        return slice(self.offsets[i], self.offsets[i] + self.sizes[i])


def stack_flatten_spec(template: Mapping[str, torch.Tensor]) -> StackFlattenSpec:
    """The flatten spec of a flat ``{name: tensor}`` model (only shapes and
    dtypes are read). Leaves go in sorted-key order, as jax flattens a
    dict, so offsets equal the reference's."""
    names, shapes, dtypes, offsets, sizes = [], [], [], [], []
    off = 0
    for name in sorted(template):
        leaf = template[name]
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"leaf {name!r} is {type(leaf).__name__}; "
                            "the flat plane takes a flat dict of tensors")
        size = int(np.prod(leaf.shape)) if leaf.dim() else 1
        names.append(name)
        shapes.append(tuple(leaf.shape))
        dtypes.append(str(leaf.dtype).replace("torch.", ""))
        offsets.append(off)
        sizes.append(size)
        off += size
    return StackFlattenSpec(names=tuple(names), shapes=tuple(shapes),
                            dtypes=tuple(dtypes), offsets=tuple(offsets),
                            sizes=tuple(sizes), total=off)


def flatten_stacked(spec: StackFlattenSpec,
                    stacked: Mapping[str, torch.Tensor],
                    dtype=torch.float32) -> torch.Tensor:
    """``{name: [K, ...]}`` -> one ``[K, P]`` buffer (row per client), so
    ``flatten_stacked(spec, t)[:, spec.columns(n)]`` is ``t[n].reshape(K, -1)``."""
    return torch.cat([stacked[n].reshape(stacked[n].shape[0], -1).to(dtype)
                      for n in spec.names], dim=1)


def unflatten_rows(spec: StackFlattenSpec,
                   rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`flatten_stacked`: ``[K, P]`` -> ``{name: [K, ...]}``
    (views into ``rows`` where the dtype already matches)."""
    k = rows.shape[0]
    return {n: rows[:, off:off + size].reshape((k,) + shape)
            .to(getattr(torch, dt))
            for n, off, size, shape, dt in zip(spec.names, spec.offsets,
                                               spec.sizes, spec.shapes,
                                               spec.dtypes)}


def unflatten_vector(spec: StackFlattenSpec,
                     vec: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One flat ``[P]`` row -> the model's ``{name: tensor}``."""
    return {n: vec[off:off + size].reshape(shape).to(getattr(torch, dt))
            for n, off, size, shape, dt in zip(spec.names, spec.offsets,
                                               spec.sizes, spec.shapes,
                                               spec.dtypes)}


def flatten_vector(spec: StackFlattenSpec,
                   params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``{name: tensor}`` -> one flat ``[P]`` fp32 row."""
    return torch.cat([params[n].reshape(-1).to(torch.float32)
                      for n in spec.names])


def params_from_jax(np_params: Mapping[str, np.ndarray],
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Reference parameters (numpy views of a jax dict) as port tensors.
    Layouts are shared (HWIO conv weights), so values carry over as-is."""
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in np_params.items()}


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_jax`: numpy arrays, which the
    reference's functions take as they are."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
