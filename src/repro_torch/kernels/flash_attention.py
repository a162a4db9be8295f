"""Causal / sliding-window GQA attention, forward, fp32 or bf16 in and out
— the self-attention of every block of the LM stacks
(``models.transformer``).

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``) with two hand-written CUDA
kernels, ``csrc/flash_attention.cu`` (fp32) and
``csrc/flash_attention_bf16.cu`` (bf16). Both keep the TPU kernel's
semantics — scale on q, queries right-aligned to keys, masked scores at
-1e30 with p forced to 0, the denominator clamped at 1e-30 so a fully
masked row gives 0 — and read KV head ``h // (H / K)`` in place of the
reference wrapper's repeat.

On the card attention is bound by operations at long sequences (4·D
flops per unmasked (q, k) pair) and by bytes and latency at the FL path's
32 tokens. Both kernels keep the score tile in registers, pack the
(q-head, query) rows of one KV head into row tiles so one K/V tile serves
the whole group, stage K/V with ``cp.async``, and split the key tiles
over several blocks when rows are few and keys many (one query against a
long cache), adding the chunks in a fixed order in a second small kernel.
The fp32 kernel computes both products with ``mma.sync`` TF32 in 3xTF32
(hi·hi + hi·lo + lo·hi, about fp32's accuracy: 495/3 TFLOP/s) over
64-row blocks and 32-key tiles. The bf16 kernel keeps q, k, v in bf16 in
shared memory and runs both products on the bf16 tensor cores
(``mma.sync`` m16n8k16, fp32 accumulators, 989 TFLOP/s) over 64-key
tiles and 128-row blocks at D <= 64 (two 16-row m-tiles a warp; 64 rows
above), the online softmax in fp32, P rounded to bf16 for P·V and the
output rounded once; it is held to the plain version within the
reference's bf16 tolerance (2e-2), not to the fp32 instance's bits.
:func:`plan_attention` is the grid plan of either (its sizes:
:func:`block_shape`), in Python so that the CPU tests can check it; no
atomics, so the result is the same bit for bit on every run. The output
is in ``q.dtype``, as the reference's kernel and oracle give it. Head
dims: 16, 32, 64, 96 (phi-3-vision) and 128.

The JAX package gives the kernel no gradient of its own, so none is owed
here: :class:`_FlashAttention`'s forward launches the kernel, its backward
differentiates :func:`flash_attention_plain` on the saved inputs (the
gradients in the inputs' dtypes).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.build import (error_string, load_function,
                                      local_shape, meta_kernels,
                                      reduce_partials)

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 96, 128)  # the kernel's template instances
BLOCK_ROWS = 64                    # packed (query, q-head) rows a block
BLOCK_KEYS = 32                    # keys a tile of the fp32 kernel
BLOCK_ROWS_BF16 = 128              # rows a block of the bf16 kernel, D <= 64
BLOCK_KEYS_BF16 = 64               # keys a tile of the bf16 kernel
SPLIT_BLOCKS = 132                 # split key tiles under this many blocks,
                                   # into about as many (the H100's SMs)
_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6
             + (ctypes.c_longlong,) * 9 + (ctypes.c_int,) * 3
             + (ctypes.c_float,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
_INT_MAX = 2 ** 31 - 1
# dtype -> (library, C symbol)
_KERNELS = {torch.float32: ("flash_attention", "flash_attention_f32"),
            torch.bfloat16: ("flash_attention_bf16", "flash_attention_bf16")}


def block_shape(dtype, d: int):
    """``(rows, keys)``: the packed rows a block and the keys a tile of the
    kernel that takes ``dtype`` at head dim ``d``. fp32: 64 × 32. bf16: 128
    × 64 at ``d`` <= 64 (two 16-row m-tiles a warp), 64 × 64 above."""
    if dtype == torch.bfloat16:
        return (BLOCK_ROWS_BF16 if d <= 64 else BLOCK_ROWS), BLOCK_KEYS_BF16
    return BLOCK_ROWS, BLOCK_KEYS


class AttentionPlan(NamedTuple):
    """The kernel's grid: ``row_tiles`` tiles of packed rows for each (b,
    KV head), each cut into ``chunks`` chunks of ``tiles_per_chunk`` key
    tiles from ``first_tile`` on (the sizes: :func:`block_shape`); one
    block per (row tile, b, KV head, chunk)."""
    row_tiles: int
    chunks: int
    tiles_per_chunk: int
    first_tile: int


def key_tile_range(q_lo: int, q_hi: int, sk: int, causal: bool, window,
                   keys: int = BLOCK_KEYS):
    """The tiles of ``keys`` keys ``(lo, hi)`` that hold an unmasked key of
    some query position in ``[q_lo, q_hi]``; ``(0, -1)`` when there is
    none. The kernels' ``key_tiles``."""
    k_lo, k_hi = 0, sk - 1
    if causal:
        k_hi = min(k_hi, q_hi)
    if window is not None:
        k_lo = max(k_lo, q_lo - window + 1)
    if k_hi < k_lo:
        return 0, -1
    return k_lo // keys, k_hi // keys


def plan_attention(B: int, Sq: int, Sk: int, H: int, K: int,
                   causal: bool = True, window=None, keys: int = BLOCK_KEYS,
                   rows: int = BLOCK_ROWS) -> AttentionPlan:
    """The grid for q ``[B, Sq, H, D]`` over k, v ``[B, Sk, K, D]`` in
    blocks of ``rows`` packed rows and tiles of ``keys`` keys (the fp32
    kernel's by default; :func:`block_shape`): a function of the shape
    alone. Key tiles are split into chunks only when the (row tile, b, KV
    head) blocks number fewer than ``SPLIT_BLOCKS``, into about
    ``SPLIT_BLOCKS`` blocks, each chunk at least two key tiles (so its
    double buffer overlaps something)."""
    row_tiles = -(-Sq * (H // K) // rows)
    lo, hi = key_tile_range(Sk - Sq, Sk - 1, Sk, causal, window, keys)
    tiles = hi - lo + 1
    base = B * K * row_tiles
    chunks = 1
    if base < SPLIT_BLOCKS:
        chunks = max(1, min(tiles // 2, -(-SPLIT_BLOCKS // base)))
    per = -(-tiles // chunks) if tiles > 0 else 1
    chunks = -(-tiles // per) if tiles > 0 else 1
    return AttentionPlan(row_tiles, chunks, per, lo)


def block_key_tiles(plan: AttentionPlan, Sq: int, Sk: int, g: int,
                    causal: bool, window, row_tile: int, chunk: int,
                    keys: int = BLOCK_KEYS, rows: int = BLOCK_ROWS) -> range:
    """The key tiles (of ``keys`` keys, the plan's) the block
    (``row_tile``, ``chunk``) of ``rows`` packed rows visits (the same for
    every b and KV head): its rows' unmasked range, cut to its chunk. Rows
    ``r`` of the tile are the pairs (query ``r // g``, q-head ``r % g`` of
    the group)."""
    r0 = row_tile * rows
    last = min(r0 + rows, Sq * g) - 1
    shift = Sk - Sq
    lo, hi = key_tile_range(r0 // g + shift, last // g + shift, Sk, causal,
                            window, keys)
    c_lo = plan.first_tile + chunk * plan.tiles_per_chunk
    return range(max(lo, c_lo), min(hi, c_lo + plan.tiles_per_chunk - 1) + 1)


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None):
    """The plain PyTorch version: dense masked scores in fp32, the TPU
    kernel's masking and clamp in one tile. q ``[B, Sq, H, D]``; k, v ``[B,
    Sk, K, D]`` -> ``[B, Sq, H, D]`` in ``q.dtype`` (the fp32 result rounded
    once for bf16)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk",
                     q.to(torch.float32) * (1.0 / math.sqrt(D)),
                     k.to(torch.float32))
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.to(torch.float32)) / denom
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q [B, Sq, H, D] and k, v "
                         f"[B, Sk, K, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)} (same B and D, H a multiple "
                         "of K)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel is built for head "
                         f"dims {HEAD_DIMS}; got {D}")
    if q.dtype not in _KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: the kernel takes q, k, v all "
                        f"float32 or all bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v lie on different devices")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel reads rows of D "
                         "contiguous values")
    if max(q.shape[1], k.shape[1]) >= 2 ** 30:
        raise ValueError("flash_attention: sequence too long for the "
                         "kernel's 32-bit positions")


def _meta_launch(q, k, causal: bool, window) -> torch.Tensor:
    """A launch's allocations on ``meta`` (``kernel_allocations``): the
    output and, where the plan splits the keys, the fp32 partial sums,
    which die on return; at each device's shard shapes under DTensor."""
    B, Sq, H, D = local_shape(q)
    Sk, K = local_shape(k)[1:3]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    # a shard whose q heads do not cover its KV heads has no plan of its
    # own (a device would take the KV heads its q heads read): one chunk
    rows, keys = block_shape(q.dtype, D)
    chunks = (plan_attention(B, Sq, Sk, H, K, causal, window, keys,
                             rows).chunks
              if K and H % K == 0 and B * H * Sq else 1)
    if chunks > 1:
        part = [torch.empty_like(q, dtype=torch.float32)
                for _ in range(chunks)]
        part += [torch.empty_like(q[..., :2], dtype=torch.float32)
                 for _ in range(chunks)]
        del part
    return out


def _launch(q, k, v, causal: bool, window) -> torch.Tensor:
    _check(q, k, v)
    if q.is_meta:
        return _meta_launch(q, k, causal, window)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    library, symbol = _KERNELS[q.dtype]
    rows, keys = block_shape(q.dtype, D)
    plan = plan_attention(B, Sq, Sk, H, K, causal, window, keys, rows)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    part_acc = part_ml = None
    if plan.chunks > 1:
        part_acc = torch.empty((plan.chunks, B, Sq, H, D), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((plan.chunks, B, Sq, H, 2), dtype=torch.float32,
                              device=q.device)
    win = 0 if window is None else max(min(int(window), _INT_MAX), -_INT_MAX)
    fn = load_function(library, symbol, _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if part_acc is None else part_acc.data_ptr(),
                 None if part_ml is None else part_ml.data_ptr(),
                 B, Sq, Sk, H, K, D, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], int(bool(causal)), int(window is not None),
                 win, 1.0 / math.sqrt(D), plan.row_tiles, plan.chunks,
                 plan.tiles_per_chunk, plan.first_tile, stream)
    if err:
        raise RuntimeError("flash_attention: kernel launch failed: "
                           + error_string(library, err))
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel. Backward: the gradient of the plain version,
    recomputed from the saved inputs (the reference has no backward
    kernel); autograd gives each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        saved = ctx.saved_tensors
        if hasattr(saved[0], "to_local"):
            return _shard_backward(*saved, grad_out, need, ctx.causal,
                                   ctx.window) + (None, None)
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            out = flash_attention_plain(*inputs, causal=ctx.causal,
                                        window=ctx.window)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(inputs, need) if n], grad_out))
        return tuple(next(grads) if n else None for n in need) + (None, None)


def _shard_backward(q, k, v, grad_out, need, causal, window):
    """The backward of DTensors on ``meta`` (the dry run's partitioned
    step): each device recomputes the plain version on its own q heads
    and the KV heads they read, as a per-device program does; a KV
    gradient is then a partial sum over the devices whose q heads share
    its head."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = q.device_mesh
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    g = grad_out.redistribute(mesh, q.placements).to_local()
    H, K, Hl, Kl = q.shape[2], k.shape[2], ql.shape[2], kl.shape[2]
    kv = Kl if Hl % Kl == 0 and Hl // Kl == H // K else max(1, Hl * K // H)
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in
                  zip((ql, kl[:, :, :kv], vl[:, :, :kv]), need)]
        out = flash_attention_plain(*inputs, causal=causal, window=window)
        grads = iter(torch.autograd.grad(
            out, [t for t, n in zip(inputs, need) if n], g))
    heads = [i for i, p in enumerate(q.placements)
             if p.is_shard() and p.dim == 2]
    result = []
    for t, n in zip((q, k, v), need):
        if not n:
            result.append(None)
            continue
        local = next(grads)
        place = list(t.placements)
        if t is not q:
            if kv < Kl:
                local = torch.zeros_like(kl)
            place = [Partial() if i in heads and not p.is_shard() else p
                     for i, p in enumerate(place)]
        result.append(DTensor.from_local(local, mesh, place,
                                         run_check=False, shape=t.shape,
                                         stride=t.stride()))
    return tuple(result)


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Attention of q ``[B, Sq, H, D]`` over k, v ``[B, Sk, K, D]`` (GQA:
    H a multiple of K) -> ``[B, Sq, H, D]`` in ``q.dtype``. A CUDA tensor
    launches the kernel (D in ``HEAD_DIMS``, all fp32 or all bf16, unit
    stride over D); a CPU tensor takes :func:`flash_attention_plain`, and
    so does a ``meta`` one, but under ``build.kernel_allocations()``."""
    if not q.is_cuda and not meta_kernels(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.is_meta:
        q, k, v = (reduce_partials(t) for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, window)


#: kernel launches so far (a plain count, reset by whoever reads it)
flash_attention.launches = 0
