"""Causal / sliding-window GQA attention, forward, in fp32 — the attention
of every dense block of the federated LM (``models.transformer``).

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``) with the hand-written CUDA kernel
``csrc/flash_attention.cu``: one block per (batch, head, 64-query tile), an
online softmax over 64-key tiles staged in shared memory, fp32 FMA, no
atomics. It keeps the TPU kernel's semantics — scale on q, queries
right-aligned to keys, masked scores at -1e30 with p forced to 0, the
denominator clamped at 1e-30 so a fully masked row gives 0 — and reads KV
head ``h // (H / K)`` in place of the reference wrapper's repeat. On the
card it is bound by operations at long sequences (4·D flops per unmasked
(q, k) pair) and by latency at the FL path's 32 tokens.

The JAX package gives the kernel no gradient of its own, so none is owed
here: :class:`_FlashAttention`'s forward launches the kernel, its backward
differentiates :func:`flash_attention_plain` on the saved inputs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import error_string, load_function

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)      # the kernel's template instances
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
             + (ctypes.c_longlong,) * 9 + (ctypes.c_int,) * 3
             + (ctypes.c_float, ctypes.c_void_p))
_INT_MAX = 2 ** 31 - 1


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None):
    """The plain PyTorch version: dense masked scores, the TPU kernel's
    masking and clamp in one tile. q ``[B, Sq, H, D]``; k, v ``[B, Sk, K,
    D]`` -> ``[B, Sq, H, D]`` fp32."""
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
    return out.permute(0, 2, 1, 3)


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
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("flash_attention: the kernel takes float32; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v lie on different devices")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel reads rows of D "
                         "contiguous values")
    if max(q.shape[1], k.shape[1]) >= 2 ** 30:
        raise ValueError("flash_attention: sequence too long for the "
                         "kernel's 32-bit positions")


def _launch(q, k, v, causal: bool, window) -> torch.Tensor:
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=torch.float32, device=q.device)
    win = 0 if window is None else max(min(int(window), _INT_MAX), -_INT_MAX)
    fn = load_function("flash_attention", "flash_attention_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, H, K, D, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], int(bool(causal)), int(window is not None),
                 win, 1.0 / math.sqrt(D), stream)
    if err:
        raise RuntimeError("flash_attention: kernel launch failed: "
                           + error_string("flash_attention", err))
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel. Backward: the gradient of the plain version,
    recomputed from the saved inputs (the reference has no backward
    kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = flash_attention_plain(*inputs, causal=ctx.causal,
                                        window=ctx.window)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(inputs, need) if n], grad_out))
        return tuple(next(grads) if n else None for n in need) + (None, None)


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Attention of q ``[B, Sq, H, D]`` over k, v ``[B, Sk, K, D]`` (GQA:
    H a multiple of K) -> ``[B, Sq, H, D]`` fp32. A CUDA tensor launches the
    kernel (D in 16/32/64/128, fp32, unit stride over D); a CPU tensor
    takes :func:`flash_attention_plain`."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _FlashAttention.apply(q, k, v, causal, window)


#: kernel launches so far (a plain count, reset by whoever reads it)
flash_attention.launches = 0
