"""Parameter / activation / cache partition rules for the production mesh
(the port of ``repro.sharding.specs``, the rules unchanged).

Divisibility-aware: every rule falls back when a dim does not divide the
``model`` axis (granite's 24 heads and 40 experts over a 16-way model
axis are the motivating cases: the fused projection dim or the expert FFN
dim is sharded instead of heads or experts).

The rules read a mesh's ``axis_names`` and ``shape`` only
(``repro_torch.launch.mesh.Mesh``), and a leaf's ``shape`` and ``ndim``
(a tensor, on ``meta`` or not). A spec is a :class:`PartitionSpec`, a
tuple of axis names, tuples of them, or ``None``; a :class:`NamedSharding`
pairs it with a mesh and gives the per-device shard shape. The port has
no SPMD partitioner: on one device every spec is replication; over a mesh
of several positions :func:`device_put` splits a leaf's last dim into
column blocks (``sharding.blocks.ColumnBlocks``), which the FL round body
reads and writes by hand (``p_shards``), and puts a replicated leaf whole
on the lead position.

Parameter trees are the port's flat dicts (``"blocks/attn/wq"``); the
path a rule reads is the name split at ``/``, as the reference's tree
path.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.sharding.blocks import ColumnBlocks
from repro_torch.train.optimizer import OptState

MODEL_AXIS = "model"
DATA_AXES = ("pod", "data")          # batch shards over whichever exist


class PartitionSpec(tuple):
    """One entry a dim: an axis name, a tuple of them, or ``None``
    (replicated); a tuple of one name is kept as the name, as JAX keeps
    it. Compares equal to the plain tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple)
                                     and len(p) == 1 else p for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A spec on a mesh."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"

    def shard_shape(self, shape) -> tuple:
        """The shape each device holds of a ``shape`` tensor."""
        out = list(shape)
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            out[i] //= int(np.prod([self.mesh.shape[a] for a in axes]))
        return tuple(out)


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _path(name: str):
    return name.split("/")


def batch_axes(mesh: Mesh, batch_size: int):
    """The tuple of mesh axes the batch dim shards over (must divide)."""
    axes = [a for a in DATA_AXES if a in mesh.axis_names]
    total = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    if axes and batch_size % total == 0:
        return tuple(axes)
    # try fewer axes (e.g. batch=1 -> replicate)
    for k in range(len(axes) - 1, 0, -1):
        sub = axes[:k]
        if batch_size % int(np.prod([mesh.shape[a] for a in sub])) == 0:
            return tuple(sub)
    return ()


def _div(dim: int, m: int) -> bool:
    return m > 1 and dim % m == 0


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

# leaf-name -> which logical dim (negative, from the right) to shard over
# `model`, in preference order. Leading stack dims (layer/group) are skipped
# automatically because rules index from the right.
_PREFERENCES = {
    "embed": (-2,),                   # [V, D]   vocab-shard
    "lm_head": (-1,),                 # [D, V]   vocab-shard
    "wq": (-1,), "wk": (-1,), "wv": (-1,),
    "bq": (-1,), "bk": (-1,), "bv": (-1,),
    "wo": (-2,),
    "w_gate": (-3, -1), "w_up": (-3, -1),   # moe [.., E, D, F]: E then F
    "w_down": (-3, -2),                      # moe [.., E, F, D]: E then F
    "router": (),
    "in_proj": (-1,),
    "out_proj": (-2,),
    "conv_w": (-1,), "conv_b": (-1,),
    "enc_in_proj": (-1,),
}
# dense (non-moe) mlp leaves share names with moe ones but have one fewer
# dim; the negative indexing handles both: dense w_gate [.., D, F] -> -3 is
# the layer-stack dim (excluded below), so the -1 fallback fires.


def param_spec(path_names, leaf, mesh: Mesh) -> PartitionSpec:
    m = _axis_size(mesh, MODEL_AXIS)
    name = path_names[-1]
    ndim = leaf.ndim
    # number of leading stack dims ("blocks"/"groups posj"/"encoder"...)
    n_stack = sum(1 for p in path_names
                  if p in ("blocks", "encoder", "decoder") or p.startswith("pos"))
    if "groups" in path_names:
        n_stack = 1  # groups/posj: one group-stack axis
    prefs = _PREFERENCES.get(name, ())
    spec = [None] * ndim
    if name in _PREFERENCES and not prefs:
        return P(*spec)                 # explicitly replicated (router, ...)
    for d in prefs:
        idx = ndim + d
        if idx < n_stack or idx < 0:
            continue
        if _div(leaf.shape[idx], m):
            spec[idx] = MODEL_AXIS
            return P(*spec)
    # fallback: largest trailing dim divisible by m (2D+ only)
    if ndim - n_stack >= 2:
        cands = sorted(range(n_stack, ndim), key=lambda i: -leaf.shape[i])
        for idx in cands:
            if _div(leaf.shape[idx], m):
                spec[idx] = MODEL_AXIS
                return P(*spec)
    return P(*spec)


def params_shardings(params: Dict, mesh: Mesh) -> Dict[str, NamedSharding]:
    """``{name: NamedSharding}`` for a flat parameter dict (tensors on any
    device, ``meta`` included)."""
    return {k: NamedSharding(mesh, param_spec(_path(k), v, mesh))
            for k, v in params.items()}


def opt_state_shardings(opt_state: OptState, params_shardings_tree,
                        mesh: Mesh) -> OptState:
    """AdamW's moments mirror the param shardings; the 0-d step
    replicates. ``params_shardings_tree`` is accepted for the reference's
    signature: each moment's spec comes from its own name and shape, as
    there."""
    def one(tree):
        if tree is None:
            return None
        return {k: NamedSharding(mesh, P() if v.ndim == 0
                                 else param_spec(_path(k), v, mesh))
                for k, v in tree.items()}
    return OptState(NamedSharding(mesh, P()), one(opt_state.m),
                    one(opt_state.v))


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------


def token_spec(mesh: Mesh, batch: int, extra_dims: int = 1) -> PartitionSpec:
    ba = batch_axes(mesh, batch)
    return P(ba if ba else None, *([None] * extra_dims))


def seq_shard_axes(mesh: Mesh, seqlen: int, used_by_batch) -> tuple:
    """Axes to shard a long sequence/cache dim over (long_500k: batch=1)."""
    free = [a for a in ("data", "model", "pod") if a in mesh.axis_names
            and a not in (used_by_batch or ())]
    out = []
    prod = 1
    for a in free:
        if seqlen % (prod * mesh.shape[a]) == 0:
            out.append(a)
            prod *= mesh.shape[a]
        if prod >= 256:
            break
    return tuple(out)


def _cache_spec(name: str, leaf, mesh: Mesh, m: int, ba) -> PartitionSpec:
    if leaf.ndim == 0 or name in ("pos", "cache_len"):
        return P()
    if name in ("k", "v", "cross_k", "cross_v"):
        # [L(, P7), B, C, K, hd]
        spec = [None] * leaf.ndim
        bdim = leaf.ndim - 4
        spec[bdim] = ba if ba else None
        if _div(leaf.shape[-2], m):
            spec[-2] = MODEL_AXIS
        elif not ba and _div(leaf.shape[-3], m):
            spec[-3] = MODEL_AXIS          # shard cache length
        elif _div(leaf.shape[-1], m):
            spec[-1] = MODEL_AXIS
        # long-context (batch unshardable): also spread C over data
        if not ba:
            seq_ax = seq_shard_axes(mesh, leaf.shape[-3],
                                    (MODEL_AXIS,) if MODEL_AXIS in spec else ())
            if seq_ax and spec[-3] is None:
                spec[-3] = seq_ax if len(seq_ax) > 1 else seq_ax[0]
        return P(*spec)
    if name == "k_pos":
        return P()
    if name == "ssm_state":
        # [L(, P7), B, H, P, N]
        spec = [None] * leaf.ndim
        spec[leaf.ndim - 4] = ba if ba else None
        for d in (-3, -2, -1):
            if _div(leaf.shape[d], m):
                spec[d] = MODEL_AXIS
                break
        return P(*spec)
    if name == "conv_state":
        # [L(, P7), B, W-1, C]
        spec = [None] * leaf.ndim
        spec[leaf.ndim - 3] = ba if ba else None
        if _div(leaf.shape[-1], m):
            spec[-1] = MODEL_AXIS
        return P(*spec)
    return P()


def cache_shardings(cfg, cache: Dict, mesh: Mesh,
                    batch: int) -> Dict[str, NamedSharding]:
    """``{name: NamedSharding}`` for a decode cache (``init_cache``'s flat
    dict; a rule reads the last ``/`` component, as the reference reads
    the tree path's last key)."""
    m = _axis_size(mesh, MODEL_AXIS)
    ba = batch_axes(mesh, batch)
    return {k: NamedSharding(mesh, _cache_spec(_path(k)[-1], v, mesh, m, ba))
            for k, v in cache.items()}


# ---------------------------------------------------------------------------
# flat parameter plane (the federated [N, P] client buffer)
# ---------------------------------------------------------------------------


def plane_spec(leaf, mesh: Mesh, p: int) -> PartitionSpec:
    """PartitionSpec for one flat-plane carry leaf.

    Any dim equal to the plane width ``p`` shards over ``model`` when
    divisible — rightmost match wins, so ``[N, P]`` shards its COLUMN axis
    and the global ``[P]`` row shards directly; leaves with no P-sized dim
    (labels, keys, scheduler state) and non-divisible planes replicate.
    The client axis N is never sharded here: it belongs to the cohort
    axis.
    """
    m = _axis_size(mesh, MODEL_AXIS)
    ndim = getattr(leaf, "ndim", 0)
    spec = [None] * ndim
    if m > 1 and p % m == 0:
        for idx in reversed(range(ndim)):
            if leaf.shape[idx] == p:
                spec[idx] = MODEL_AXIS
                break
    return P(*spec)


def plane_shardings(tree, mesh: Mesh, p: int):
    """A ``NamedSharding`` for every tensor of a flat-plane carry (a
    tensor — a :class:`ColumnBlocks` too —, or a dict, list, tuple or
    named tuple of them; other leaves, ``None`` included, stay as they
    are)."""
    return _map_tensors(
        tree, lambda t: NamedSharding(mesh, plane_spec(t, mesh, p)))


def _map_tensors(tree, fn):
    if hasattr(tree, "shape"):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def device_put(tree, shardings):
    """Each tensor of ``tree`` laid out as its ``NamedSharding`` in
    ``shardings`` (a tree that mirrors it: dicts by key, tuples and named
    tuples by position; other leaves stay as they are). A replicated
    spec, or any spec on a one-device mesh, puts the tensor whole on the
    mesh's first (lead) position (itself when it lies there). Over a mesh
    of several positions a spec that splits the last dim over the mesh's
    one axis of more than one position gives a :class:`ColumnBlocks`, a
    contiguous block a position, each copied to its position's device
    (a ``ColumnBlocks`` already laid out so is itself); any other split
    raises."""
    if isinstance(shardings, NamedSharding):
        mesh = shardings.mesh
        devices = list(mesh.devices.flat)
        split = [i for i, e in enumerate(shardings.spec) if e is not None]
        if isinstance(tree, ColumnBlocks):
            if split and tree.same_layout(devices):
                return tree
            tree = tree.assemble()
        if mesh.size == 1 or not split:
            return tree.to(devices[0])
        axes = [a for a, n in mesh.shape.items() if n > 1]
        if (split != [tree.dim() - 1] or len(axes) != 1
                or shardings.spec[split[0]] not in (axes[0], (axes[0],))):
            raise NotImplementedError(
                f"spec {shardings.spec} over the mesh {mesh.shape}: the port "
                "splits only a leaf's last dim over a mesh's one axis")
        return ColumnBlocks.split(tree, devices)
    if isinstance(tree, dict):
        return {k: device_put(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(device_put(v, s)
                            for v, s in zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(device_put(v, s) for v, s in zip(tree, shardings))
    return tree


def lead_shardings(tree, mesh: Mesh):
    """A replicated ``NamedSharding`` for every tensor of ``tree`` (the
    walk of :func:`plane_shardings`): :func:`device_put` puts each whole
    on the mesh's lead position."""
    return _map_tensors(tree, lambda t: NamedSharding(mesh, P()))


def plane_mesh(p_shards: int, device="cuda") -> Optional[Mesh]:
    """A 1-axis ``model`` mesh over ``min(p_shards, devices)`` devices of
    ``device``'s kind (``None`` when sharding is off): the cards this
    host sees, in order, or the one CPU device. A one-device mesh is
    valid: its shardings are replication, so the path runs anywhere.
    Over several positions the plane's columns split (``FLExperiment``),
    one block a position."""
    if p_shards <= 0:
        return None
    host = make_host_mesh(1, p_shards, device=device)
    return Mesh((MODEL_AXIS,), {MODEL_AXIS: host.size},
                host.devices.reshape(host.size))
