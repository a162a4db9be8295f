"""Mamba-2's SSD scan, fp32 or bf16 x, b, c (fp32 inside) — the sequence
mixer of every Mamba-2 block of the LM stacks (``models.layers.
mamba2_apply``, which widens to fp32 first, as the reference does).

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py``
(``ssd_scan`` / ``_ssd_kernel``) with the hand-written CUDA kernel
``csrc/ssd_scan.cu``, computing what it computes: per (batch·head), chunks
of ``Q = min(chunk, S)`` steps, the decay-masked intra-chunk
``(C·Bᵀ ⊙ L)·X`` plus the carried state read out through C, and the state
carried from chunk to chunk; it returns y and the final fp32 state.

On the card it is bound by operations (per (b·h, chunk of ``Ql`` steps)
``Ql(Ql+1)(N+P)`` flops over the causal triangle, ``2·Ql·P·N`` for the chunk
state and, after the first chunk, ``2·Ql·P·N`` for the carried read-out;
on the tensor cores in 3xTF32: 495/3 TFLOP/s). In place of the TPU
kernel's sequential chunk axis the chunks run in parallel, in the
decomposition of the reference's ``ssd_chunked``: chunk states, state
passing in chunk order, then y. One chunk (every call of the FL path) is
one launch; more chunks are three. Every product runs through ``mma.sync``
TF32 in 3xTF32. :func:`plan_ssd` is the grid and the shared memory, in
Python so that the CPU tests can check it; the kernel takes the plan's
counts and sizes as arguments and refuses a plan that does not match its
decode. No atomics, so two calls give the same bits. Group
``h // (H / G)`` of b and c is read in place of the reference wrapper's
repeat. bf16 x, b, c launch the bf16 instance (a, ``[B, S, H]``, is
widened here): it widens them exactly into the fp32 tiles and rounds y
once, so y is the fp32 instance's on the widened inputs rounded to bf16
and the state is that instance's fp32 state, bit for bit. y comes back in
``x.dtype`` and the state in fp32, as the reference's kernel gives them.

The JAX package gives the kernel no gradient of its own: :class:`_SsdScan`'s
forward launches the kernel, its backward differentiates the chunked form
``kernels.ssd_chunked.ssd_chunked`` (:func:`ssd_scan_grads`), which the
reference itself trains through off the TPU.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import (error_string, load_function,
                                      local_shape, meta_kernels,
                                      reduce_partials)
from repro_torch.kernels.ssd_chunked import ssd_chunked

BLOCK_ROWS = 64                    # y rows a block
BLOCK_KEYS = 32                    # steps a B / X tile
BLOCK_P = 64                       # columns of P a block
BLOCK_N = 64                       # columns of N a state block
_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 16
             + (ctypes.c_longlong,) * 12 + (ctypes.c_void_p,))
_SMEM_LIMIT = 232_448              # bytes of shared memory a block may use
_SYMBOLS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


class SsdPlan(NamedTuple):
    """The kernel's grid for one call. ``chunks`` chunks of ``q`` steps,
    the last ``last`` long. y blocks: one per (b·h, chunk, row tile of
    ``BLOCK_ROWS``, tile of ``BLOCK_P`` columns of P) — ``row_tiles`` row
    tiles in a full chunk, ``last_row_tiles`` in the last. State blocks:
    one per (b·h, chunk, P tile, tile of ``BLOCK_N`` columns of N).
    ``y_smem`` and ``state_smem`` bytes of shared memory a block of each
    role (:func:`smem_bytes`). ``launches`` device launches: 1 for one
    chunk (y and state blocks together), else 3 (states, passing, y).

    The kernel decodes block ``k < y_blocks`` of a launch as a y block, row
    tiles from the last (the most key tiles) to the first, within one
    chunk-major, then b·h, then the P tile (the last chunk has only
    ``last_row_tiles``); the rest as state blocks, chunk-major, then b·h,
    then the P tile, then the N tile."""
    q: int
    chunks: int
    last: int
    row_tiles: int
    last_row_tiles: int
    p_tiles: int
    n_tiles: int
    y_blocks: int
    state_blocks: int
    y_smem: int
    state_smem: int
    launches: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_ssd(B: int, S: int, H: int, P: int, N: int, chunk: int) -> SsdPlan:
    """The grid for x ``[B, S, H, P]`` and b, c ``[., ., ., N]`` at
    ``chunk``: a function of the shapes alone, passed to the kernel."""
    q = min(chunk, S)
    chunks = _cdiv(S, q)
    last = S - (chunks - 1) * q
    row_tiles, last_row_tiles = _cdiv(q, BLOCK_ROWS), _cdiv(last, BLOCK_ROWS)
    p_tiles, n_tiles = _cdiv(P, BLOCK_P), _cdiv(_cdiv(N, 8) * 8, BLOCK_N)
    bh = B * H
    y_blocks = bh * p_tiles * ((chunks - 1) * row_tiles + last_row_tiles)
    state_blocks = bh * chunks * p_tiles * n_tiles
    return SsdPlan(q, chunks, last, row_tiles, last_row_tiles, p_tiles,
                   n_tiles, y_blocks, state_blocks,
                   *smem_bytes(q, N, chunks), 1 if chunks == 1 else 3)


def smem_bytes(q: int, n: int, chunks: int):
    """Shared memory of a (y block, state block) at chunk ``q``, state
    width ``n`` and ``chunks`` chunks: the chunk's cumsum, then for a y
    block the C tile (``min(64, round16(q))`` rows) and the (B, X) stages
    (two, or one when ``q <= BLOCK_KEYS``) with rows padded to
    ``round8(n) + 4`` and ``BLOCK_P + 4``, which also hold h_in
    ``[BLOCK_P, round8(n) + 4]`` when there is more than one chunk; for a
    state block its (X, B) stages with rows padded to 72 floats."""
    qa = _cdiv(q, 64) * 64
    np_ = _cdiv(n, 8) * 8 + 4
    rows = min(BLOCK_ROWS, _cdiv(q, 16) * 16)
    n_stages = 2 if q > BLOCK_KEYS else 1
    stages = n_stages * BLOCK_KEYS * (np_ + BLOCK_P + 4)
    h_in = BLOCK_P * np_ if chunks > 1 else 0
    y = qa + rows * np_ + max(stages, h_in)
    state = qa + n_stages * 2 * BLOCK_KEYS * 72
    return 4 * y, 4 * state


def ssd_scan_plain(x, a, b, c):
    """The plain PyTorch version: the token-by-token recurrence of
    ``ref.ssd_ref`` (in fp32) after the group expansion of ``ops.ssd``.
    x ``[B, S, H, P]``, a ``[B, S, H]``, b, c ``[B, S, G, N]`` ->
    ``(y [B, S, H, P] in x.dtype, state [B, H, P, N] fp32)``."""
    rep = x.shape[2] // b.shape[2]
    if rep > 1:
        b = b.repeat_interleave(rep, dim=2)
        c = c.repeat_interleave(rep, dim=2)
    y, state = ref.ssd_ref(x, a, b, c)
    return y.to(x.dtype), state


def _check(x, a, b, c, chunk):
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"ssd_scan: want x [B, S, H, P], a [B, S, H], b, c "
                         f"[B, S, G, N]; got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    B, S, H, P = x.shape
    if tuple(a.shape) != (B, S, H) or b.shape[:2] != (B, S) or H % b.shape[2]:
        raise ValueError(f"ssd_scan: a {tuple(a.shape)} and b/c "
                         f"{tuple(b.shape)} do not fit x {tuple(x.shape)}")
    if P % 8:
        raise ValueError(f"ssd_scan: the kernel takes P a multiple of 8; "
                         f"got {P}")
    if (x.dtype not in _SYMBOLS or b.dtype != x.dtype or c.dtype != x.dtype
            or a.dtype not in _SYMBOLS):
        raise TypeError(f"ssd_scan: the kernel takes x, b, c all float32 or "
                        f"all bfloat16 and a float a; got {x.dtype}, "
                        f"{a.dtype}, {b.dtype}, {c.dtype}")
    if any(t.device != x.device for t in (a, b, c)):
        raise ValueError("ssd_scan: x, a, b, c lie on different devices")
    if any(t.stride(3) != 1 for t in (x, b, c)):
        raise ValueError("ssd_scan: the kernel reads rows of P (x) and N "
                         "(b, c) contiguous values")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be positive; got {chunk}")
    if max(x.numel(), b.numel(), B * H * P * b.shape[3] * _cdiv(S, chunk)
           ) >= 2 ** 31:
        raise ValueError("ssd_scan: too large for the kernel's 32-bit "
                         "indices")


def _meta_launch(x, b, chunk: int):
    """A launch's allocations on ``meta`` (``kernel_allocations``): y, the
    final state and, over several chunks, the chunk states and decays,
    which die on return; at each device's shard shapes under DTensor."""
    B, S, H, P = local_shape(x)
    N = local_shape(b)[3]
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    state = torch.empty_like(x[:, 0, :, :, None].expand(-1, -1, -1, N),
                             dtype=torch.float32,
                             memory_format=torch.contiguous_format)
    chunks = plan_ssd(B, S, H, P, N, chunk).chunks if S else 1
    if chunks > 1:
        st = [torch.empty_like(state) for _ in range(chunks)]
        del st
    return y, state


def _laid_out_as(x, a, b, c):
    """DTensors ``a``, ``b``, ``c`` split over the batch and sequence as
    ``x`` is (and ``a`` over the heads too), the rest replicated: the
    shards one device's kernel reads."""
    from torch.distributed.tensor import Replicate

    def like(t, dims):
        want = [p if p.is_shard() and p.dim in dims else Replicate()
                for p in x.placements]
        return t.redistribute(t.device_mesh, want)
    return like(a, (0, 1, 2)), like(b, (0, 1)), like(c, (0, 1))


def _launch(x, a, b, c, chunk: int):
    if x.is_meta:
        # the kernel's limits hold for the shard one device holds
        _check(*(t.to_local() if hasattr(t, "to_local") else t
                 for t in (x, a, b, c)), chunk)
        return _meta_launch(x, b, chunk)
    _check(x, a, b, c, chunk)
    a = a.to(torch.float32)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    if S == 0:
        return y, torch.zeros((B, H, P, N), dtype=torch.float32,
                              device=x.device)
    plan = plan_ssd(B, S, H, P, N, chunk)
    need = max(plan.y_smem, plan.state_smem)
    if need > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {plan.q} with N = {N} needs "
                         f"{need} bytes of shared memory")
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    st = dec = None
    if plan.chunks > 1:
        st = torch.empty((B * H, plan.chunks, P, N), dtype=torch.float32,
                         device=x.device)
        dec = torch.empty((B * H, plan.chunks), dtype=torch.float32,
                          device=x.device)
    fn = load_function("ssd_scan", _SYMBOLS[x.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 y.data_ptr(), state.data_ptr(),
                 None if st is None else st.data_ptr(),
                 None if dec is None else dec.data_ptr(),
                 B, S, H, G, P, N, plan.q, plan.chunks, plan.row_tiles,
                 plan.last_row_tiles, plan.p_tiles, plan.n_tiles,
                 plan.y_blocks, plan.state_blocks, plan.y_smem,
                 plan.state_smem,
                 *x.stride()[:3], *a.stride(), *b.stride()[:3],
                 *c.stride()[:3], stream)
    if err:
        raise RuntimeError("ssd_scan: kernel launch failed: "
                           + error_string("ssd_scan", err))
    ssd_scan.launches += 1
    return y, state


def ssd_scan_grads(x, a, b, c, chunk: int, grad_y, grad_state, need):
    """The gradients of (y, state) with respect to x, a, b, c (those that
    ``need`` marks; None elsewhere) for the cotangents ``grad_y`` and
    ``grad_state`` (either may be None): autograd through
    ``kernels.ssd_chunked.ssd_chunked`` at the kernel's chunk
    ``min(chunk, S)``, recomputed from the inputs widened to fp32, each
    gradient given back in its input's dtype. On the card its einsums run
    in full fp32 (``core.fedavg.fp32_matmuls`` keeps TF32 off)."""
    q = max(1, min(chunk, x.shape[1]))
    f32 = torch.float32
    with torch.enable_grad():
        inputs = [t.detach().to(f32).requires_grad_(n)
                  for t, n in zip((x, a, b, c), need)]
        outs = [(o, g.to(f32)) for o, g in zip(ssd_chunked(*inputs, q),
                                               (grad_y, grad_state))
                if g is not None]
        grads = iter(torch.autograd.grad(
            [o for o, _ in outs], [t for t, n in zip(inputs, need) if n],
            [g for _, g in outs]))
    return tuple(next(grads).to(t.dtype) if n else None
                 for t, n in zip((x, a, b, c), need))


class _SsdScan(torch.autograd.Function):
    """Forward: the kernel. Backward: the gradient of the chunked form,
    recomputed from the saved inputs (the reference has no backward
    kernel)."""

    @staticmethod
    def forward(ctx, x, a, b, c, chunk):
        ctx.save_for_backward(x, a, b, c)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _launch(x, a, b, c, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        return ssd_scan_grads(*ctx.saved_tensors, ctx.chunk, grad_y,
                              grad_state, ctx.needs_input_grad[:4]) + (None,)


def ssd_scan(x, a, b, c, *, chunk: int = 256):
    """SSD of x ``[B, S, H, P]`` (pre-scaled by dt), log-decay a ``[B, S,
    H]`` and b, c ``[B, S, G, N]`` (H a multiple of G) ->
    ``(y [B, S, H, P] in x.dtype, final state [B, H, P, N] fp32)``. A
    CUDA tensor launches the kernel (x, b, c all fp32 or all bf16); a CPU
    tensor takes :func:`ssd_scan_plain`. A ``meta`` tensor (shapes only:
    the dry run's counts) takes the plain chunked form, ``ssd_chunked``,
    whose work is the kernel's and not a loop of S token steps; under
    ``build.kernel_allocations()`` it takes the kernel's route instead and
    allocates what a launch holds."""
    if meta_kernels(x):
        x, a, b, c = (reduce_partials(t) for t in (x, a, b, c))
        if hasattr(x, "placements"):
            a, b, c = _laid_out_as(x, a, b, c)
        return _SsdScan.apply(x, a, b, c, chunk)
    if x.is_meta:
        y, state = ssd_chunked(x, a, b, c, chunk)
        return y.to(x.dtype), state
    if not x.is_cuda:
        return ssd_scan_plain(x, a, b, c)
    return _SsdScan.apply(x, a, b, c, chunk)


#: kernel calls so far (a plain count, reset by whoever reads it)
ssd_scan.launches = 0
