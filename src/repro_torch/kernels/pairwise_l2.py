"""Pairwise squared L2 distances, ``[N, F] × [M, F] -> [N, M]`` in fp32 —
K-means assignment and k-means++ (M = clusters, F = the feature layer)
and, with the global row as the one centroid, the divergence signal
(M = 1, F = P).

Replaces the Pallas TPU kernel ``src/repro/kernels/pairwise_l2.py``
(``pairwise_l2`` / ``_pairwise_l2_kernel``) with the hand-written CUDA
kernel ``csrc/pairwise_l2.cu``. On the card it is bound by bytes (three
flops per eight bytes read). The kernel computes the direct ``Σ(x−c)²``
— not the TPU body's per-slab ``‖x‖²+‖c‖²−2x·c``, which cancels badly
for a client row close to the global row — with one block per ``(n, m)``
pair and a fixed-shape tree reduction: no atomics, deterministic.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import error_string, load_function

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def pairwise_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[N, M]`` between the rows of x ``[N, F]`` and
    c ``[M, F]``, both fp32 and contiguous on one device. A CUDA tensor
    launches the kernel; a CPU tensor takes ``ref.pairwise_l2_ref``."""
    if not x.is_cuda:
        return ref.pairwise_l2_ref(x, c)
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"pairwise_l2: want x [N, F] and c [M, F]; got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"pairwise_l2: the kernel takes float32; got "
                        f"{x.dtype} and {c.dtype}")
    if c.device != x.device:
        raise ValueError("pairwise_l2: x and c lie on different devices "
                         f"({x.device}, {c.device})")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("pairwise_l2: the kernel takes contiguous tensors")
    (n, f), m = x.shape, c.shape[0]
    if max(x.numel(), c.numel(), n * m) >= 2 ** 31:
        raise ValueError(f"pairwise_l2: [{n},{f}]x[{m},{f}] exceeds the "
                         "kernel's 32-bit sizes")
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    fn = load_function("pairwise_l2", "pairwise_l2_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), c.data_ptr(), out.data_ptr(), n, m, f, stream)
    if err:
        raise RuntimeError("pairwise_l2: kernel launch failed: "
                           + error_string("pairwise_l2", err))
    pairwise_l2.launches += 1
    return out


#: kernel launches so far (a plain count, reset by whoever reads it)
pairwise_l2.launches = 0
