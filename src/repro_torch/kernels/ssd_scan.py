"""Mamba-2's SSD scan in fp32 — the sequence mixer of every Mamba-2 block
of the federated LM (``models.layers.mamba2_apply``).

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py``
(``ssd_scan`` / ``_ssd_kernel``) with the hand-written CUDA kernel
``csrc/ssd_scan.cu``, computing what it computes: per (batch·head), chunks
of ``Q = min(chunk, S)`` steps, the decay-masked intra-chunk
``(C·Bᵀ ⊙ L)·X`` plus the carried state read out through C, and the state
carried from chunk to chunk; it returns y and the final fp32 state. On the
card it is bound by operations (``2Q²(N+P) + 4QPN`` flops per (b·h,
chunk)). One block per (b·h, slice of P columns) runs the chunks in order
with the slice's state in shared memory and builds the ``[Q, Q]`` block 32
rows by 32 columns at a time (at Q = 256 it would not fit whole); the slice
width is chosen so that small B·H still fills the SMs. Group ``h // (H /
G)`` of b and c is read in place of the reference wrapper's repeat.

The JAX package gives the kernel no gradient of its own: :class:`_SsdScan`'s
forward launches the kernel, its backward differentiates
:func:`ssd_scan_plain` on the saved inputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import error_string, load_function

SLICES = (64, 32, 16, 8)           # the kernel's P-slice template instances
_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8
             + (ctypes.c_longlong,) * 12 + (ctypes.c_void_p,))
_TILE = 32
_SMEM_LIMIT = 232_448              # bytes of shared memory a block may use


def ssd_scan_plain(x, a, b, c):
    """The plain PyTorch version: the token-by-token recurrence of
    ``ref.ssd_ref`` after the group expansion of ``ops.ssd``.
    x ``[B, S, H, P]``, a ``[B, S, H]``, b, c ``[B, S, G, N]`` ->
    ``(y [B, S, H, P], state [B, H, P, N])``."""
    rep = x.shape[2] // b.shape[2]
    if rep > 1:
        b = b.repeat_interleave(rep, dim=2)
        c = c.repeat_interleave(rep, dim=2)
    return ref.ssd_ref(x, a, b, c)


def _smem_bytes(q: int, n: int, ps: int) -> int:
    np_ = n + 1
    return 4 * (-(-q // 4) * 4 + 2 * _TILE * np_ + _TILE * ps
                + _TILE * (_TILE + 1) + ps * np_ + 8)


def p_slice(bh: int, p: int, sms: int) -> int:
    """Columns of P per block: the widest slice that still gives the card's
    ``sms`` SMs a block each, else the narrowest the kernel has."""
    fits = [ps for ps in SLICES if p % ps == 0]
    if not fits:
        raise ValueError(f"ssd_scan: the kernel takes P a multiple of 8; "
                         f"got {p}")
    return next((ps for ps in fits if bh * (p // ps) >= sms), fits[-1])


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
    if any(t.dtype != torch.float32 for t in (x, a, b, c)):
        raise TypeError("ssd_scan: the kernel takes float32")
    if any(t.device != x.device for t in (a, b, c)):
        raise ValueError("ssd_scan: x, a, b, c lie on different devices")
    if any(t.stride(3) != 1 for t in (x, b, c)):
        raise ValueError("ssd_scan: the kernel reads rows of P (x) and N "
                         "(b, c) contiguous values")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be positive; got {chunk}")


def _launch(x, a, b, c, chunk: int):
    _check(x, a, b, c, chunk)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    q = min(chunk, S)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ps = p_slice(B * H, P, sms)
    if _smem_bytes(q, N, ps) > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {q} with N = {N} needs "
                         f"{_smem_bytes(q, N, ps)} bytes of shared memory")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    fn = load_function("ssd_scan", "ssd_scan_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 y.data_ptr(), state.data_ptr(), B, S, H, G, P, N, q, ps,
                 *x.stride()[:3], *a.stride(), *b.stride()[:3],
                 *c.stride()[:3], stream)
    if err:
        raise RuntimeError("ssd_scan: kernel launch failed: "
                           + error_string("ssd_scan", err))
    ssd_scan.launches += 1
    return y, state


class _SsdScan(torch.autograd.Function):
    """Forward: the kernel. Backward: the gradient of the plain version,
    recomputed from the saved inputs (the reference has no backward
    kernel)."""

    @staticmethod
    def forward(ctx, x, a, b, c, chunk):
        ctx.save_for_backward(x, a, b, c)
        ctx.set_materialize_grads(False)
        return _launch(x, a, b, c, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            outs = [(o, g) for o, g in zip(ssd_scan_plain(*inputs),
                                           (grad_y, grad_state))
                    if g is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in outs], [t for t, n in zip(inputs, need) if n],
                [g for _, g in outs]))
        return tuple(next(grads) if n else None for n in need) + (None,)


def ssd_scan(x, a, b, c, *, chunk: int = 256):
    """SSD of x ``[B, S, H, P]`` (pre-scaled by dt), log-decay a ``[B, S,
    H]`` and b, c ``[B, S, G, N]`` (H a multiple of G) ->
    ``(y [B, S, H, P], final state [B, H, P, N])`` fp32. A CUDA tensor
    launches the kernel; a CPU tensor takes :func:`ssd_scan_plain`."""
    if not x.is_cuda:
        return ssd_scan_plain(x, a, b, c)
    return _SsdScan.apply(x, a, b, c, chunk)


#: kernel launches so far (a plain count, reset by whoever reads it)
ssd_scan.launches = 0
