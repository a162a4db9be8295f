"""The flat parameter plane: one model's named tensors as a length-``P`` row.

The FL round treats every client model as one Euclidean point, so N client
models live in a single ``[N, P]`` buffer and selection, K-means and
aggregation are row operations on it. A port row is the SAME vector as a
reference row: leaves are laid out in jax's pytree order, which sorts the
keys of every dict level (``b_c1, b_c2, b_fc1, b_fc2, w_c1, ...``), not
``nn.Module`` insertion order; each leaf is reshaped row-major. A nested
reference tree is a flat port dict whose names are the ``/``-joined key
paths (``blocks/attn/wq_a``), as the reference names its spec's leaves.
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


def tree_order(names):
    """``/``-joined leaf names in jax's flatten order of the nested dict
    they name: sorted by key at every level."""
    return sorted(names, key=lambda n: n.split("/"))


def stack_flatten_spec(template: Mapping[str, torch.Tensor]) -> StackFlattenSpec:
    """The flatten spec of a flat ``{name: tensor}`` model (only shapes and
    dtypes are read). Leaves go in :func:`tree_order`, as jax flattens the
    nested dict, so offsets equal the reference's."""
    names, shapes, dtypes, offsets, sizes = [], [], [], [], []
    off = 0
    for name in tree_order(template):
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


def unflatten_rows_np(spec: StackFlattenSpec,
                      rows: np.ndarray) -> Dict[str, np.ndarray]:
    """Host-numpy twin of :func:`unflatten_rows`: ``[K, P]`` host rows ->
    ``{name: [K, ...]}`` (views where the dtype already matches), so the
    paged store's chunks unflatten with no device round trip."""
    rows = np.asarray(rows)
    k = rows.shape[0]
    return {n: np.asarray(rows[:, off:off + size], dtype=dt)
            .reshape((k,) + shape)
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


def _is_bfloat16(a: np.ndarray) -> bool:
    """A numpy array of ``ml_dtypes.bfloat16`` (what jax hands out for a
    bf16 array), told apart by name so that nothing here imports
    ``ml_dtypes``."""
    return a.dtype.name == "bfloat16"


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A host array as a tensor on ``device`` (a copy), bf16 included: a
    bf16 array goes across as its 16 bits (an ``int16`` view) and is viewed
    back as ``torch.bfloat16``, bit for bit (torch takes no ``ml_dtypes``
    array)."""
    a = np.asarray(a)
    if _is_bfloat16(a):
        bits = torch.tensor(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`tensor_from_numpy`: a bf16 tensor comes back as an
    ``ml_dtypes.bfloat16`` array (imported here only, where a caller asks
    for one), bit for bit."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(np_params: Mapping, device="cpu") -> Dict[str, torch.Tensor]:
    """Reference parameters (a dict of arrays, nested or flat) as a flat
    port dict named by ``/``-joined key paths. Layouts are shared (HWIO
    conv weights, ``[d_in, d_out]`` projections), so values carry over
    as-is, bf16 bit for bit (:func:`tensor_from_numpy`)."""
    out = {}

    def walk(prefix, node):
        for k, v in node.items():
            name = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(name, v)
            else:
                out[name] = tensor_from_numpy(v, device)

    walk("", np_params)
    return out


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`params_from_jax`: the nested dict of numpy arrays
    that the reference's functions take (bf16 leaves as
    ``ml_dtypes.bfloat16`` arrays, :func:`tensor_to_numpy`)."""
    out: Dict = {}
    for name, v in params.items():
        *path, leaf = name.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = tensor_to_numpy(v)
    return out


def tree_global_norm(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ over every leaf of Σ x²) in fp32, leaves in :func:`tree_order`
    (a 0-d tensor on the leaves' device)."""
    names = tree_order(params)
    if not names:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(params[n].to(torch.float32)))
                          for n in names))


def tree_num_params(params: Mapping[str, torch.Tensor]) -> int:
    return sum(int(v.numel()) for v in params.values())


def tree_bytes(params: Mapping[str, torch.Tensor]) -> int:
    return sum(int(v.numel()) * v.element_size() for v in params.values())


def tree_flatten_vector(params: Mapping[str, torch.Tensor],
                        dtype=torch.float32) -> torch.Tensor:
    """Every leaf, in :func:`tree_order`, as one 1-D vector: a model as one
    Euclidean point (divergence, K-means features)."""
    names = tree_order(params)
    if not names:
        return torch.zeros((0,), dtype=dtype)
    return torch.cat([params[n].reshape(-1).to(dtype) for n in names])


def tree_unflatten_vector(template: Mapping[str, torch.Tensor],
                          vector: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`tree_flatten_vector` given a template dict (its
    shapes and dtypes)."""
    out, idx = {}, 0
    for n in tree_order(template):
        leaf = template[n]
        size = leaf.numel()
        out[n] = vector[idx:idx + size].reshape(leaf.shape).to(leaf.dtype)
        idx += size
    return out


def tree_add(a, b):
    return {k: a[k] + b[k] for k in a}


def tree_sub(a, b):
    return {k: a[k] - b[k] for k in a}


def tree_scale(a, s):
    return {k: v * s for k, v in a.items()}


def tree_zeros_like(tree):
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def tree_weighted_mean(trees, weights):
    """Weighted average of a list of dicts — FedAvg aggregation, eq. (4):
    ``Σ_n D_n w_n / Σ_n D_n``, in fp32, each leaf back in its dtype."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    norm = w / torch.sum(w)
    return {k: torch.tensordot(norm.to(trees[0][k].device),
                               torch.stack([t[k].to(torch.float32)
                                            for t in trees]), dims=1)
            .to(trees[0][k].dtype) for k in trees[0]}


def tree_weighted_mean_stacked(stacked, weights):
    """FedAvg aggregation (eq. 4) over a stacked client axis: each leaf
    of ``stacked`` is ``[N, ...]``; ``Σ_n w_n x_n / Σ_n w_n`` in fp32,
    each leaf back in its dtype."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    norm = w / torch.sum(w)
    out = {}
    for k, leaf in stacked.items():
        n = norm.to(leaf.device).reshape((-1,) + (1,) * (leaf.dim() - 1))
        out[k] = torch.sum(leaf.to(torch.float32) * n, dim=0).to(leaf.dtype)
    return out


def tree_cast(tree, dtype):
    """Floating leaves cast to ``dtype``; the others as they are."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}
