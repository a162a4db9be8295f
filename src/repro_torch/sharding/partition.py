"""A step partitioned over a logical mesh with no cards: DTensor over
torch's fake process group, on ``meta`` tensors.

The reference reads a step's collectives from XLA's SPMD partitioner (the
HLO of the per-device program). The port has no partitioner of its own,
so :func:`run_partitioned` lets DTensor play that part: one process holds
a fake process group of ``mesh.size`` ranks (no communication happens:
every collective is a shape computation on ``meta``), each argument of the
step becomes a ``DTensor`` whose local tensor is rank 0's shard under the
partition rules (``repro_torch.sharding.specs``), and the step runs once.
DTensor's sharding propagation then issues the collectives a device would
run, and :class:`CollectiveBytes` adds up their bytes.

How bytes are counted: a collective's bytes are the bytes of its RESULT
on one device, the reference's convention (``collective_bytes`` parses
the result shape of each collective in the per-device HLO). So an
all-gather counts the gathered tensor, a reduce-scatter its scattered
part, an all-reduce and an all-to-all their operand's size once. The
totals are per device (rank 0's; the rules only shard dims that divide
the mesh axes, so every rank's shards are the same size).

Where the partitioners differ. DTensor propagates one op at a time and
picks the layout that is cheapest for that op; XLA propagates over the
whole program. Left alone, DTensor gathers the whole vocabulary onto
every device at the loss, reduce-scatters a layer's output into a layout
the next layer must gather again, and refuses some layouts outright (an
unflatten of a dim sharded unevenly over the split). The run therefore
adds rules where XLA's partitioner does otherwise, each stated where it
is defined:

- :class:`VocabParallel`: the embedding lookup, log-softmax and gather on
  a vocabulary-sharded dim run on the shards (XLA's masked lookup and
  partitioned reduction);
- :class:`PartitionRules`: a layer's partial sums are all-reduced where
  they meet the residual; the decode cache's ``index_copy_`` runs on each
  shard; an op DTensor refuses runs again contiguous, then replicated
  over the mesh's last dim, ..., then over all (each such op is counted
  in ``PartitionedRun.refusals``);
- the kernels' wrappers (``kernels.build.kernel_allocations``): attention
  and the SSD scan run on each device's heads, as a kernel does.

The counts follow DTensor's own propagation elsewhere, which changes
between torch versions (a record names the version it was made with).
A step that still fails, or one that issues a collective this module
does not know, gives ``collectives = None`` and the reason, never a
count of 0.
"""
from __future__ import annotations

import contextlib
import math
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.launch.mesh import Mesh
from repro_torch.roofline.analysis import (_COLLECTIVES, PeakMemory,
                                           _on_dtensors)

#: the reference's collective kinds, in its order (``collective_bytes``)
COLLECTIVE_KINDS = _COLLECTIVES


def _collective_kinds() -> Dict:
    """The functional collectives DTensor issues, by op packet, and the
    reference's name of each."""
    fn = torch.ops._c10d_functional
    kinds = {fn.all_gather_into_tensor: "all-gather",
             fn.all_reduce: "all-reduce",
             fn.reduce_scatter_tensor: "reduce-scatter",
             fn.all_to_all_single: "all-to-all",
             torch.ops._dtensor.shard_dim_alltoall: "all-to-all"}
    unknown = (fn.all_gather_into_tensor_coalesced, fn.all_reduce_coalesced,
               fn.reduce_scatter_tensor_coalesced, fn.broadcast)
    return kinds, set(unknown)


class CollectiveBytes(TorchDispatchMode):
    """Counts each functional collective a step issues and its result's
    bytes on one device (the module docstring), by the reference's kind.
    Ops on DTensors pass through (``NotImplemented``) so that DTensor
    desugars them into the local ops and collectives this mode sees."""

    def __init__(self):
        super().__init__()
        self.kinds, self.unknown = _collective_kinds()
        self.bytes = Counter()
        self.counts = Counter()
        self.other = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        packet = getattr(func, "_overloadpacket", None)
        kind = self.kinds.get(packet)
        if kind is not None:
            self.counts[kind] += 1
            self.bytes[kind] += sum(t.numel() * t.element_size()
                                    for t in tree_leaves(out)
                                    if isinstance(t, torch.Tensor))
        elif packet in self.unknown:
            self.other[str(packet)] += 1
        return out

    def record(self) -> Dict:
        """The reference's ``collective_bytes`` dict: ``total``,
        ``counts`` by kind, and the bytes of each kind."""
        per_kind = {k: int(self.bytes[k]) for k in COLLECTIVE_KINDS}
        return {"total": sum(per_kind.values()),
                "counts": {k: int(self.counts[k]) for k in COLLECTIVE_KINDS},
                **per_kind}


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _reduce_partials(args, mode):
    """``args`` of a sum with the partial sums among its DTensors reduced
    where another operand is not partial on the same mesh dim (GSPMD's
    all-reduce of a product's partial sums where it meets the residual;
    DTensor would reduce-scatter them and gather the result again)."""
    from torch.distributed.tensor import DTensor, Replicate
    dts = [x for x in args if isinstance(x, DTensor)]
    if len(dts) < 2:
        return args
    ndim = dts[0].device_mesh.ndim
    mixed = [i for i in range(ndim)
             if len({x.placements[i].is_partial() for x in dts}) > 1]
    if not mixed:
        return args

    def reduce(x):
        if not isinstance(x, DTensor):
            return x
        place = [Replicate() if i in mixed and p.is_partial() else p
                 for i, p in enumerate(x.placements)]
        return mode.redistribute(x, place)
    return tuple(reduce(x) for x in args)


_SUMS = {torch.ops.aten.add.Tensor, torch.ops.aten.sub.Tensor}
# how DTensor refuses an op: no rule, no rule for these placements, or
# (torch 2.11) no plan to redistribute its arguments
_REFUSALS = (RuntimeError, NotImplementedError, IndexError)


def _index_copy_on_shards(mode, dst, dim, index, src):
    """``dst.index_copy_(dim, index, src)`` on each device's shard (the
    decode cache's write; torch 2.11's DTensor has no rule for it): the
    source laid out as ``dst`` but replicated where ``dst`` shards
    ``dim``, the index whole."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = dst.device_mesh
    dims = _mesh_dims_sharding(dst, dim)
    want = [Replicate() if i in dims else p
            for i, p in enumerate(dst.placements)]
    if isinstance(src, DTensor):
        src = mode.redistribute(src, want).to_local()
    if isinstance(index, DTensor):
        index = mode.redistribute(index, [Replicate()] * mesh.ndim)
        index = index.to_local()
    dst.to_local().index_copy_(dim, index, src)
    return dst


class PartitionRules(TorchDispatchMode):
    """The partitioned run's rules at the op level, where DTensor's differ
    from XLA's partitioner or differ between torch versions:

    - a sum whose operands are partial sums on some mesh dim and not on
      another reduces the partial ones first (:func:`_reduce_partials`);
    - ``index_copy_`` (the decode cache's write) runs on each device's
      shard, and ``detach_`` (autograd bookkeeping) on the DTensor as it
      is, in every torch version, whether or not DTensor has a rule;
    - an op DTensor refuses runs again on its arguments made contiguous (a
      view of a permuted shard), then replicated over the mesh's last dim,
      then over the last two, ... then over all, and, where DTensor has no
      rule for it at all, on each device's whole copy. ``refusals`` counts
      the ops so answered, by name; an op that writes into its input is
      not retried.

    A dispatch mode, so the backward pass's ops and a remat's recomputed
    forward come under it as well."""

    def __init__(self):
        super().__init__()
        self.refusals = Counter()

    def redistribute(self, x, placements):
        """``x.redistribute`` from within a rule, with this mode in force
        again for the ops it runs (torch 2.11 detaches its result)."""
        with self:
            return x.redistribute(x.device_mesh, placements)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        if not _on_dtensors(types):
            return func(*args, **kwargs)
        if func is torch.ops.aten.index_copy_.default:
            return _index_copy_on_shards(self, *args, **kwargs)
        if func is torch.ops.aten.detach_.default:
            return args[0]
        if func in _SUMS:
            args = _reduce_partials(args, self)
        try:
            return func(*args, **kwargs)
        except _REFUSALS as e:
            dts = [x for x in tree_leaves((args, kwargs))
                   if isinstance(x, DTensor)]
            if not dts or func._schema.is_mutable:
                raise
            no_rule = "does not have a sharding strategy" in str(e)
            ndim = dts[0].device_mesh.ndim

            def fix(first):
                def one(x):
                    if not isinstance(x, DTensor):
                        return x
                    if first is None:
                        return x.contiguous()
                    place = list(x.placements)
                    place[first:] = [Replicate()] * (ndim - first)
                    return self.redistribute(x, place)
                return one

            tries = [None] * any(not x.to_local().is_contiguous()
                                 for x in dts) + list(range(ndim - 1, -1, -1))
            # (a try that fails after gathering leaves its gathers counted)
            for first in () if no_rule else tries:
                try:
                    out = func(*tree_map(fix(first), args),
                               **tree_map(fix(first), kwargs))
                except _REFUSALS:
                    continue
                self.refusals[str(func)] += 1
                return out
            # no rule at all (torch 2.11 has none for ``flip``): the op on
            # each device's whole copy, its result replicated
            whole = fix(0)
            args, kwargs = tree_map(whole, args), tree_map(whole, kwargs)
            mesh = dts[0].device_mesh
            out = func(*tree_map(_local, args), **tree_map(_local, kwargs))
            self.refusals[str(func)] += 1
            return tree_map(lambda t: DTensor.from_local(
                t, mesh, [Replicate()] * ndim, run_check=False)
                if isinstance(t, torch.Tensor) else t, out)


def _mesh_dims_sharding(x, dim: int) -> list:
    """The mesh dims over which DTensor ``x`` shards its dim ``dim``."""
    dim %= x.ndim
    return [i for i, p in enumerate(x.placements)
            if p.is_shard() and p.dim == dim]


def _replicated_on(t, dims, like=None):
    """DTensor ``t`` laid out as ``like`` (default: itself) on every mesh
    dim but ``dims``, and replicated on those."""
    from torch.distributed.tensor import Replicate
    like = t if like is None else like
    want = [Replicate() if i in dims else p
            for i, p in enumerate(like.placements)]
    return t.redistribute(t.device_mesh, want)


def _reduced(local, like, dims, shape):
    """``local``, each device's partial sum over the mesh dims ``dims``
    (laid out as ``like`` elsewhere), summed across them: the result
    replicated there (an all-reduce of the result's size)."""
    from torch.distributed.tensor import DTensor, Partial
    place = [Partial() if i in dims else p
             for i, p in enumerate(like.placements)]
    out = DTensor.from_local(local, like.device_mesh, place,
                             run_check=False, shape=shape,
                             stride=_contiguous_stride(shape))
    return _replicated_on(out, dims)


def _contiguous_stride(shape):
    stride, out = 1, []
    for n in reversed(tuple(shape)):
        out.append(stride)
        stride *= n
    return tuple(reversed(out))


class _ShardedLookup(torch.autograd.Function):
    """``table[ids]`` of a table sharded on its rows: each device looks
    its ids up in its own rows (a real run masks the ids it lacks) and the
    rows are summed across the row-sharding mesh dims. Backward: each
    device adds the gradient into its own rows."""

    @staticmethod
    def forward(ctx, table, ids, dims):
        ids = _replicated_on(ids, dims)
        ctx.save_for_backward(ids)
        ctx.table = (table.device_mesh, table.placements, table.shape,
                     table.dtype)
        return _reduced(table.to_local()[ids.to_local()], ids, dims,
                        tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        (ids,) = ctx.saved_tensors
        mesh, placements, shape, dtype = ctx.table
        g = grad.redistribute(mesh, ids.placements)
        rows = torch.zeros(_local_of(shape, placements, mesh), dtype=dtype,
                           device=g.to_local().device)
        rows.index_put_((ids.to_local(),), g.to_local().to(dtype),
                        accumulate=True)
        # over the mesh dims that split the batch, each device holds its
        # batch's part of the gradient: a partial sum
        place = [p if p.is_shard() else
                 (Partial() if q.is_shard() else Replicate())
                 for p, q in zip(placements, ids.placements)]
        return DTensor.from_local(rows, mesh, place, run_check=False,
                                  shape=shape,
                                  stride=_contiguous_stride(shape)), \
            None, None


def _local_of(shape, placements, mesh):
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


class _ShardedLogSoftmax(torch.autograd.Function):
    """Log-softmax over a dim its input shards: the max and the sum of
    exponentials reduced across the shards (two all-reduces of the other
    dims' size), the result sharded as the input."""

    @staticmethod
    def forward(ctx, x, dim):
        m = torch.amax(x, dim, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(x - m), dim, keepdim=True)) + m
        out = x - lse
        ctx.save_for_backward(out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        total = torch.sum(grad, ctx.dim, keepdim=True)
        return grad - torch.exp(out) * total, None


class _ShardedGather(torch.autograd.Function):
    """``torch.gather`` on each device's part: along a dim the input
    shards (the mesh dims ``dims``), a real run masks the indices a
    device lacks and the results are summed across those mesh dims.
    Backward: each device scatters the gradient into its own part (where
    DTensor's would first make a zero tensor of the whole input on every
    device)."""

    @staticmethod
    def forward(ctx, x, dim, index, dims):
        index = _replicated_on(index, dims, like=x)
        ctx.save_for_backward(index)
        ctx.x = (x.device_mesh, x.placements, x.shape, x.dtype)
        ctx.dim = dim
        return _reduced(torch.gather(x.to_local(), dim, index.to_local()),
                        index, dims, tuple(index.shape))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        (index,) = ctx.saved_tensors
        mesh, placements, shape, dtype = ctx.x
        g = grad.redistribute(mesh, index.placements)
        part = torch.zeros(_local_of(shape, placements, mesh), dtype=dtype,
                           device=g.to_local().device)
        part.scatter_add_(ctx.dim, index.to_local(), g.to_local().to(dtype))
        return DTensor.from_local(part, mesh, placements, run_check=False,
                                  shape=shape,
                                  stride=_contiguous_stride(shape)), \
            None, None, None


class VocabParallel(TorchFunctionMode):
    """The three ops that read a dim the vocabulary shards, as XLA's
    partitioner runs them (DTensor would gather the whole vocabulary onto
    every device first): an embedding lookup in a row-sharded table
    (``table[ids]``), ``torch.log_softmax`` over the sharded dim, and
    ``torch.gather`` (along it, or along any dim: DTensor's backward of a
    gather makes the whole input's zeros on every device). Each runs on
    the shards and reduces only what the result needs. Any other call
    passes through, and so does every call inside a remat block (its
    recompute runs in the backward pass, outside this mode; the model's
    lookup and loss lie outside the blocks)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if torch._C._autograd._top_saved_tensors_default_hooks(False):
            # inside a remat block: its recompute in the backward pass runs
            # without this mode, so the block must run the plain ops here
            return func(*args, **kwargs)
        if func is torch.Tensor.__getitem__ and len(args) == 2:
            table, ids = args
            if (isinstance(table, DTensor) and isinstance(ids, DTensor)
                    and table.ndim == 2 and not ids.is_floating_point()
                    and _mesh_dims_sharding(table, 0)):
                return _ShardedLookup.apply(table, ids,
                                            _mesh_dims_sharding(table, 0))
        elif func in (torch.log_softmax, torch.Tensor.log_softmax,
                      torch.nn.functional.log_softmax):
            x = args[0]
            dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if (isinstance(x, DTensor) and dim is not None
                    and kwargs.get("dtype") is None
                    and _mesh_dims_sharding(x, dim)):
                return _ShardedLogSoftmax.apply(x, dim % x.ndim)
        elif func in (torch.gather, torch.Tensor.gather):
            x, dim, index = (list(args) + [kwargs.get("dim"),
                                           kwargs.get("index")])[:3]
            if (isinstance(x, DTensor) and isinstance(index, DTensor)
                    and index.ndim == x.ndim and not kwargs.get(
                        "sparse_grad") and not any(
                        p.is_partial() for p in x.placements)):
                return _ShardedGather.apply(x, dim % x.ndim, index,
                                            _mesh_dims_sharding(x, dim))
        return func(*args, **kwargs)


def _sharding_leaves(tree):
    if hasattr(tree, "spec") and hasattr(tree, "mesh"):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _sharding_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _sharding_leaves(v)


def _entries(shardings):
    for sh in _sharding_leaves(shardings):
        for entry in sh.spec:
            if entry is not None:
                yield entry if isinstance(entry, tuple) else (entry,)


def axis_groups(mesh: Mesh, shardings) -> list:
    """The mesh axes the specs of ``shardings`` use, as DTensor's mesh
    dims: axes that every spec uses together, in mesh order and next to
    each other in each entry (the 2×16×16 mesh's ``("pod", "data")``
    batch), make ONE dim of their sizes' product, and axes no spec uses
    are left out. A device holds the same shards either way; a merged
    dim's collective is one op over its group where a dim each would be
    one op a dim (what DTensor itself advises, and what XLA's partitioner
    emits), and DTensor's propagation, whose cost grows with the mesh's
    dims, runs on fewer."""
    entries = set(_entries(shardings))
    used = [a for a in mesh.axis_names if any(a in e for e in entries)]

    def together(x, a):
        return all((x in e) == (a in e) and
                   (x not in e or e.index(a) == e.index(x) + 1)
                   for e in entries)

    groups = []
    for a in used:
        if groups and together(groups[-1][-1], a):
            groups[-1] += (a,)
        else:
            groups.append((a,))
    return groups or [(mesh.axis_names[-1],)]


@contextlib.contextmanager
def fake_device_mesh(mesh: Mesh, groups=None):
    """A ``DeviceMesh`` over a fake process group in this process (rank
    0), torn down on exit: one dim a group of ``mesh``'s axes in
    ``groups`` (default: one dim an axis), named by its axes joined with
    ``+``, of their sizes' product. Refuses to run beside a process group
    of the caller's."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_device_mesh: a process group is already "
                           "initialized in this process")
    groups = groups or [(a,) for a in mesh.axis_names]
    sizes = [math.prod(mesh.shape[a] for a in g) for g in groups]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(sizes))
    try:
        # "cuda": the collectives a card runs (a "cpu" mesh would gather
        # where a card's all-to-all moves a shard); no device is touched
        yield DeviceMesh("cuda", torch.arange(math.prod(sizes)).reshape(
            sizes), mesh_dim_names=tuple("+".join(g) for g in groups))
    finally:
        dist.destroy_process_group()


def placements(sharding, dmesh) -> list:
    """A ``NamedSharding``'s spec as DTensor placements on ``dmesh``: the
    dim holding mesh axis ``a`` (a dim is named by its axes joined with
    ``+``) shards tensor dim ``d`` where ``a`` appears in the spec's entry
    ``d`` (a tuple of axes shards one dim over each, in order)."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {a: i for i, name in enumerate(dmesh.mesh_dim_names)
              for a in name.split("+")}
    out = [Replicate()] * dmesh.ndim
    for d, entry in enumerate(sharding.spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[dim_of[axis]] = Shard(d)
    return out


def distribute(tree, shardings, dmesh):
    """Each tensor of ``tree`` (dicts by key, tuples and named tuples by
    position, as ``specs.device_put`` reads them) as a ``DTensor`` on
    ``dmesh``: a ``meta`` local tensor of rank 0's shard shape under its
    ``NamedSharding`` in ``shardings``. Other leaves stay as they are."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.Tensor):
        local = torch.empty(shardings.shard_shape(tree.shape),
                            dtype=tree.dtype, device="meta")
        return DTensor.from_local(local, dmesh, placements(shardings, dmesh),
                                  run_check=False, shape=tree.shape,
                                  stride=tree.stride())
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k], dmesh)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(v, s, dmesh)
                            for v, s in zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s, dmesh)
                          for v, s in zip(tree, shardings))
    return tree


@dataclass
class PartitionedRun:
    """One run of a step partitioned over a logical mesh.
    ``collectives``: the reference's ``collective_bytes`` dict, per
    device, or ``None`` with ``reason`` saying why; ``peak_bytes``: the
    high-water mark of live tensor bytes on one device over the step
    (``roofline.analysis.PeakMemory``), ``None`` where the run failed;
    ``refusals``: the ops DTensor refused and ran replicated;
    ``seconds``: the run's wall time; ``mesh``: DTensor's mesh dims and
    their sizes (:func:`axis_groups`)."""
    collectives: Optional[Dict]
    peak_bytes: Optional[float]
    reason: Optional[str] = None
    refusals: Dict[str, int] = field(default_factory=dict)
    seconds: float = 0.0
    mesh: Dict[str, int] = field(default_factory=dict)


def run_partitioned(fn: Callable, args: tuple, in_shardings: tuple,
                    mesh: Mesh) -> PartitionedRun:
    """Runs ``fn(*args)`` (``meta`` structs) once partitioned over
    ``mesh`` (the module docstring) under ``CommDebugMode``, whose counts
    by kind must equal :class:`CollectiveBytes`', and under
    ``roofline.analysis.PeakMemory``, which holds the arguments' local
    shards from the start (the caller keeps them) and adds every local
    tensor the step makes."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.perf_counter()
    refuse, count, peak = PartitionRules(), CollectiveBytes(), PeakMemory()
    groups = axis_groups(mesh, in_shardings)
    dims = {"+".join(g): math.prod(mesh.shape[a] for a in g) for g in groups}

    def failed(reason, peak_bytes=None):
        return PartitionedRun(None, peak_bytes, reason=reason,
                              refusals=dict(refuse.refusals),
                              seconds=time.perf_counter() - t0, mesh=dims)

    try:
        with fake_device_mesh(mesh, groups) as dmesh:
            dargs = tuple(distribute(a, s, dmesh)
                          for a, s in zip(args, in_shardings))
            peak.hold(x.to_local() for x in tree_leaves(dargs)
                      if isinstance(x, DTensor))
            with CommDebugMode() as comm, peak, count, \
                    implicit_replication(), refuse, VocabParallel():
                out = fn(*dargs)
            del out, dargs
    except Exception as e:  # noqa: BLE001 — the reason goes in the record
        return failed(f"{type(e).__name__}: {str(e)[:300]}")
    if count.other:
        return failed(f"collectives not counted: {dict(count.other)}",
                      peak.peak)
    record = count.record()
    theirs = Counter()
    for packet, n in comm.get_comm_counts().items():
        theirs[_kind_name(packet)] += n
    if dict(theirs) != {k: n for k, n in record["counts"].items() if n}:
        return failed(f"CommDebugMode counted {dict(theirs)}, the byte "
                      f"counter {record['counts']}", peak.peak)
    return PartitionedRun(record, float(peak.peak),
                          refusals=dict(refuse.refusals),
                          seconds=time.perf_counter() - t0, mesh=dims)


def _kind_name(packet) -> str:
    """CommDebugMode's key (a legacy ``c10d_functional`` packet, or
    ``_dtensor.shard_dim_alltoall``) as the reference's kind."""
    name = str(packet).split(".")[-1].split("'")[0]
    return {"all_gather_into_tensor": "all-gather",
            "all_reduce": "all-reduce",
            "reduce_scatter_tensor": "reduce-scatter",
            "all_to_all_single": "all-to-all",
            "shard_dim_alltoall": "all-to-all"}.get(name, name)
