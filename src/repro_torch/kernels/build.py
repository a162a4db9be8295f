"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named by a hash of its source,
the shared headers of ``csrc/`` and the flags, then loaded with
``ctypes``. No PyTorch headers are involved,
so a build takes seconds. Nothing is compiled when a module is imported.

:func:`kernel_allocations` is the one switch a wrapper reads besides its
tensor's device: under it a ``meta`` call of ``flash_attention`` or
``ssd_scan`` takes the kernel's route and allocates what a launch holds
on the card, with no kernel run and no launch counted (the dry run's peak
memory; off, ``meta`` takes the plain version, whose work the FLOP count
reads).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

from repro_torch.utils.spans import span

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


_META_KERNELS = [False]   # a plain flag: autograd may recompute elsewhere


@contextlib.contextmanager
def kernel_allocations():
    """Within: ``meta`` calls of the kernel wrappers allocate what a
    launch holds on the card (the module docstring)."""
    before = _META_KERNELS[0]
    _META_KERNELS[0] = True
    try:
        yield
    finally:
        _META_KERNELS[0] = before


def meta_kernels(t) -> bool:
    """Does ``t`` take the kernel's allocations on ``meta``?"""
    return _META_KERNELS[0] and t.is_meta


def reduce_partials(t):
    """``t`` with any partial sums among a DTensor's placements reduced
    (an all-reduce): a kernel's inputs are whole values on each device."""
    if not any(p.is_partial() for p in getattr(t, "placements", ())):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


def local_shape(t) -> tuple:
    """The shape one device holds of ``t``: a DTensor's local shard, any
    other tensor's own shape."""
    return tuple(t.to_local().shape if hasattr(t, "to_local") else t.shape)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``; raises if
    neither exists."""
    home = os.environ.get("CUDA_HOME")
    if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
        return os.path.join(home, "bin", "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError("nvcc not found in $CUDA_HOME/bin or on PATH: the "
                       "CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by its source, every
    shared header of ``csrc/`` (``*.cuh``, which a source may include) and
    the flags, so that a changed header never loads a stale library."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str], ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns each compiled
    kernel's compiler output (``-Xptxas -v`` adds register and shared
    memory counts); raises on the first failed build."""
    todo = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    procs = {}
    for n in todo:
        # build to a private name, then rename: concurrent builds of the
        # same source never see a half-written library
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(n))
        else:
            failed.append(n)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load_function(name: str, symbol: str, argtypes: Tuple) -> ctypes._CFuncPtr:
    """``symbol`` of library ``name`` with its ``argtypes`` declared (a
    pointer passed without them is cut to 32 bits) and an ``int`` result,
    building the library first if needed."""
    with span("fl.kernel_load", kernel=name, symbol=symbol,
              nvcc=not library_path(name).exists()):
        build([name])
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def error_string(name: str, code: int) -> str:
    """CUDA's text for error ``code`` (each library exports
    ``<name>_error_string``)."""
    fn = getattr(ctypes.CDLL(str(library_path(name))), f"{name}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()
