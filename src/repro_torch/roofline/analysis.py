"""Roofline analysis of a step (the port of ``repro.roofline.analysis``).

Three terms, per (arch × shape × mesh), against the H100's peaks
(``repro_torch.launch.mesh.H100_SXM``):

    compute    = FLOPs_per_device / peak bf16 FLOP/s
    memory     = bytes_per_device / HBM bytes/s
    collective = collective_bytes_per_device / NVLink bytes/s

The counts come from running the step once on ``meta`` structs
(:func:`analyze_step`): FLOPs from ``torch.utils.flop_counter``, bytes
from the tensors each aten op reads and writes. Eager execution runs every
layer, so there is nothing for a loop to hide (the reference needs a
layer-unrolled twin because XLA counts a scan body once). The collective
bytes and the peak memory a device holds come from a second run of the
step, partitioned over the mesh with DTensor on a fake process group
(``repro_torch.sharding.partition``) under :class:`PeakMemory`; where
``collective_bytes_per_device`` is ``None`` (the partitioned run failed)
the collective term is left out. :func:`analyze_compiled` reads a
``Lowered`` step into a :class:`RooflineReport`, as the reference reads a
compiled program. ``collective_bytes`` parses an XLA HLO text as the
reference does.
"""
from __future__ import annotations

import functools
import re
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.build import kernel_allocations
from repro_torch.launch.mesh import H100_SXM, Mesh

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# matches e.g.:  %ag = bf16[8,2048,128]{2,1,0} all-gather(...)
_OP_RE = re.compile(
    r"=\s*(?:\()?\s*([a-z0-9]+)\[([0-9,]*)\][^ ]*\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
# tuple-result collectives:  = (bf16[..], bf16[..]) all-reduce(...)
_TUPLE_RE = re.compile(
    r"=\s*\(([^)]*)\)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-collective-type output bytes of the per-device HLO module.

    '-start' ops are counted, matching '-done' twins are skipped.
    """
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue                      # avoid double counting async pairs
        m = _OP_RE.search(line)
        if m:
            dtype, dims, op = m.groups()
            out[op] += _shape_bytes(dtype, dims)
            counts[op] += 1
            continue
        m = _TUPLE_RE.search(line)
        if m:
            shapes, op = m.groups()
            for sm in _SHAPE_RE.finditer(shapes):
                out[op] += _shape_bytes(*sm.groups())
            counts[op] += 1
    out_total = sum(out.values())
    return {"total": out_total, "counts": counts, **out}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: Optional[float]
    model_flops_global: float
    peak_memory_per_device: Optional[float] = None
    collectives: Optional[Dict] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / H100_SXM["peak_bf16_flops"]

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / H100_SXM["hbm_bandwidth"]

    @property
    def collective_s(self) -> Optional[float]:
        if self.collective_bytes_per_device is None:
            return None
        return self.collective_bytes_per_device / H100_SXM["ici_bandwidth"]

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / FLOPs_global — remat/redundancy waste detector."""
        flops_global = self.flops_per_device * self.chips
        return self.model_flops_global / flops_global if flops_global else 0.0

    @property
    def step_time_s(self) -> float:
        """No-overlap roofline estimate of the step time."""
        return max(self._terms().values())

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "peak_memory_per_device": self.peak_memory_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "collectives": self.collectives,
        }


def model_flops(cfg, shape, *, include_backward: bool) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N = active params."""
    n = cfg.num_params(active_only=cfg.moe is not None)
    if shape.is_decode:
        tokens = shape.global_batch                       # one new token each
    else:
        tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if include_backward else 2.0
    return mult * n * tokens


# ---------------------------------------------------------------------------
# counting a step
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that alias their input or only allocate: no bytes move
_NO_TRAFFIC = {_aten._unsafe_view.default, _aten.empty.memory_format,
               _aten.empty_strided.default, _aten.empty_like.default,
               _aten.new_empty.default, _aten.new_empty_strided.default}


def _tensors(tree):
    """The tensors of a nested dict / tuple / list (other leaves
    dropped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _ByteCounter(TorchDispatchMode):
    """Adds up, for every aten op but views, the bytes of its tensor
    arguments and results."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in
                              _tensors((args, kwargs or {}, out)))
        return out


def _on_dtensors(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class PeakMemory(TorchDispatchMode):
    """The high-water mark of live tensor bytes over a step run under it.

    A tensor's bytes are its storage's, added when an op returns a
    storage not seen before (a view or an in-place result adds nothing)
    and taken off when the storage dies: each storage carries a weak
    reference whose callback subtracts it (torch keeps one Python object
    a storage, so the reference fires when the last tensor viewing it is
    freed, whether Python or autograd's saved tensors held it).
    :meth:`hold` adds what the caller keeps alive beside the step (its
    arguments). Ops on tensor subclasses (DTensor) pass through
    (``NotImplemented``), so under a partitioned run the mode sees the
    local shards: bytes on one device. On ``meta`` no memory is touched;
    what the port holds on the card is what it holds here, but where a
    kernel replaces its plain version (run ``meta`` steps under
    ``kernel_allocations()``)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs = {}

    def _free(self, key, n, _ref):
        if self._refs.pop(key, None) is not None:
            self.live -= n

    def _add(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(
            st, functools.partial(self._free, key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def hold(self, tensors):
        """Counts ``tensors`` (an iterable, or a tree as ``_tensors``
        reads it) as live from now on, as long as they live."""
        for t in _tensors(tensors if isinstance(tensors, (dict, tuple, list,
                                                          torch.Tensor))
                          else list(tensors)):
            self._add(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if type(t) is torch.Tensor:   # not DTensor's fake shape probes
                self._add(t)
        return out


def peak_memory(fn: Callable, *args, **kwargs) -> float:
    """The high-water mark of live tensor bytes over ``fn(*args,
    **kwargs)`` on one device, its arguments held throughout
    (:class:`PeakMemory`). Run it on ``meta`` under
    ``kernels.build.kernel_allocations()`` for what the card holds."""
    mode = PeakMemory()
    mode.hold((args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    del out
    return float(mode.peak)


@dataclass
class StepCount:
    flops: float
    bytes: float
    outputs: object


def analyze_step(fn: Callable, *args, **kwargs) -> StepCount:
    """Run ``fn(*args, **kwargs)`` once (on ``meta`` structs: shapes only,
    no memory) and count it: ``flops`` as ``FlopCounterMode`` counts them
    (matrix products and convolutions, forward and backward), ``bytes`` as
    the sum over every aten op but views of the bytes of its tensor
    arguments and results. That is XLA's "bytes accessed" of the eager,
    unfused step, an upper bound on its HBM traffic: a fused kernel keeps
    most of it on the chip."""
    bytes_mode = _ByteCounter()
    with FlopCounterMode(display=False) as flops_mode, bytes_mode:
        out = fn(*args, **kwargs)
    return StepCount(float(flops_mode.get_total_flops()),
                     float(bytes_mode.bytes), out)


class Lowered:
    """A step over structs, the counterpart of a lowered XLA program: the
    step function ``fn``, its arguments ``args`` (``meta`` structs), their
    shardings ``in_shardings`` and the results' ``out_shardings`` (trees of
    ``NamedSharding`` mirroring them) on ``mesh``; ``donate``: the
    positions of arguments whose memory the results reuse.
    :meth:`cost_analysis` counts one run on the structs,
    :meth:`partitioned` runs them partitioned over the mesh (collectives
    and peak memory); :meth:`compile` gives the callable that runs on
    real tensors. ``split``: ``host mesh -> (step, positions)``, the
    step's hand-written split over a host mesh of several positions
    (``None``: the step has none)."""

    def __init__(self, fn: Callable, args: tuple, in_shardings: tuple,
                 out_shardings, *, mesh: Mesh, donate: tuple = (),
                 split: Optional[Callable] = None):
        self.fn = fn
        self.args = args
        self.in_shardings = in_shardings
        self.out_shardings = out_shardings
        self.mesh = mesh
        self.donate = donate
        self.split = split
        self.positions: Optional[int] = None
        self.step_count: Optional[StepCount] = None
        self._partitioned = None

    def count(self) -> StepCount:
        """:func:`analyze_step` of the step on its structs, run once (the
        same on any mesh: a caller may hand one lowering's count to
        another's ``step_count``)."""
        if self.step_count is None:
            self.step_count = analyze_step(self.fn, *self.args)
        return self.step_count

    def cost_analysis(self) -> Dict[str, float]:
        """The step run whole: ``{"flops", "bytes accessed"}``."""
        c = self.count()
        return {"flops": c.flops, "bytes accessed": c.bytes}

    def partitioned(self, run: bool = True):
        """The step run once partitioned over the mesh under the
        kernels' allocations (``sharding.partition.run_partitioned``):
        its collectives and its tracked peak a device, or the reason it
        failed. Run once; a one-device mesh runs the step whole under
        :class:`PeakMemory` (no collectives: 0 bytes of each kind).
        ``run=False`` runs nothing: ``None`` for both, and the reason."""
        from repro_torch.sharding.partition import (PartitionedRun,
                                                    run_partitioned)
        if self._partitioned is None and not run:
            return PartitionedRun(None, None, reason="not partitioned "
                                  "(counted only)")
        if self._partitioned is None:
            with kernel_allocations():
                if self.mesh.size == 1:
                    t0 = time.perf_counter()
                    peak = peak_memory(self.fn, *self.args)
                    self._partitioned = PartitionedRun(
                        _no_collectives(), peak,
                        seconds=time.perf_counter() - t0)
                else:
                    self._partitioned = run_partitioned(
                        self.fn, self.args, self.in_shardings, self.mesh)
        return self._partitioned

    def peak_memory_per_device(self) -> Optional[float]:
        """The high-water mark of live bytes a device holds over the
        step, temporaries and the caller's arguments included
        (:meth:`partitioned`); ``None`` where that run failed."""
        return self.partitioned().peak_bytes

    def memory_per_device(self) -> float:
        """Bytes a device holds of the arguments and results under the
        shardings, the donated arguments counted once: a lower bound on
        the step's peak (temporaries left out;
        :meth:`peak_memory_per_device` counts them)."""
        args = sum(_held(a, s) for i, (a, s) in enumerate(
            zip(self.args, self.in_shardings)) if i not in self.donate)
        return float(args + _held(self.count().outputs, self.out_shardings))

    def compile(self, device) -> Callable:
        """The step on real tensors, its lead on ``device``: the function
        itself on a one-device mesh of that device; on a host mesh of
        several positions the step's own split (``split``), which sets
        ``positions`` (1 where it runs whole on the lead). A logical mesh,
        and a host mesh the step has no split for, raise: the port has no
        SPMD partitioner."""
        if self.mesh.logical or (self.mesh.size > 1 and self.split is None):
            raise NotImplementedError(
                f"a step over a {self.mesh.size}-device "
                f"{'logical ' if self.mesh.logical else ''}mesh: the port "
                "has no SPMD partitioner (one device runs the step whole; "
                "the FL round splits its clients over a host mesh)")
        dev, own = torch.device(device), self.mesh.devices.flat[0]
        if (dev.type, dev.index or 0) != (own.type, own.index or 0):
            raise ValueError(f"compile({dev}): the mesh's device is {own}")
        if self.mesh.size == 1:
            self.positions = 1
            return self.fn
        step, self.positions = self.split(self.mesh)
        return step


def _no_collectives() -> Dict:
    return {"total": 0, "counts": {k: 0 for k in _COLLECTIVES},
            **{k: 0 for k in _COLLECTIVES}}


def analyze_compiled(lowered: Lowered, *, arch: str, shape, mesh_name: str,
                     chips: int, cfg, include_backward: bool,
                     partition: bool = True) -> RooflineReport:
    """The counterpart of the reference's ``analyze_compiled``: a lowered
    step read into a :class:`RooflineReport`. FLOPs and bytes a device
    are the step's counts (:meth:`Lowered.cost_analysis`) over ``chips``,
    a perfect split; the collective bytes, their kinds and counts, and the
    peak memory are those of the partitioned run
    (:meth:`Lowered.partitioned`), ``None`` where it failed or, under
    ``partition=False``, was not run."""
    cost = lowered.cost_analysis()
    run = lowered.partitioned(partition)
    coll = run.collectives
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=cost["flops"] / chips,
        bytes_per_device=cost["bytes accessed"] / chips,
        collective_bytes_per_device=(None if coll is None
                                     else float(coll["total"])),
        model_flops_global=model_flops(cfg, shape,
                                       include_backward=include_backward),
        peak_memory_per_device=run.peak_bytes, collectives=coll)


def _held(tree, shards) -> int:
    """Bytes a device holds of ``tree`` (tensors in dicts, tuples and
    lists) under ``shards``, a tree of ``NamedSharding``s that mirrors it
    (dicts by key)."""
    if isinstance(tree, torch.Tensor):
        n = tree.element_size()
        for d in shards.shard_shape(tree.shape):
            n *= int(d)
        return n
    if isinstance(tree, dict):
        return sum(_held(v, shards[k]) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return sum(_held(v, s) for v, s in zip(tree, shards))
    return 0
