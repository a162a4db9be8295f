"""The chunked SSD form of the reference (``repro.models.layers.ssd_chunked``
with ``_segsum``): Mamba-2's parallel form in four einsums and a loop over
chunks, plain PyTorch as the reference leaves it to XLA.

``ssd_scan``'s backward differentiates it (the kernel has no backward of
its own); ``models.layers`` re-exports it under the reference's name. It
lives here so that the kernels never import the model layer.
"""
from __future__ import annotations

import torch


def _segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (i >= j),
    -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, float("-inf"))


def ssd_chunked(X, A, Bm, Cm, chunk: int, initial_state=None):
    """SSD (state-space duality) chunked scan — Mamba2's parallel form, as
    the reference writes it (four einsums and a loop over chunks).

    X: [B, S, H, P] (pre-multiplied by dt); A: [B, S, H] log-decay (dt*A_raw,
    negative); Bm, Cm: [B, S, G, N]. Heads are grouped: G divides H.
    Returns (Y: [B, S, H, P], final_state: [B, H, P, N]). ``ssd_scan``'s
    backward differentiates this form; on the card its einsums run in full
    fp32 (``core.fedavg.fp32_matmuls``).
    """
    B, S, H, P = X.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    pad = (-S) % chunk
    if pad:
        X = torch.nn.functional.pad(X, (0, 0, 0, 0, 0, pad))
        A = torch.nn.functional.pad(A, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
    S_p = S + pad
    nc = S_p // chunk
    Xc = X.reshape(B, nc, chunk, H, P)
    Ac = A.reshape(B, nc, chunk, H).permute(0, 3, 1, 2)       # [B,H,nc,Q]
    Bh = Bm.reshape(B, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Ch = Cm.reshape(B, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    A_cum = torch.cumsum(Ac, dim=-1)                          # [B,H,nc,Q]

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(Ac))                                # [B,H,nc,Q,Q]
    scores = torch.einsum("bcqhn,bcshn->bhcqs", Ch, Bh)       # [B,H,nc,Q,Q]
    Y_diag = torch.einsum("bhcqs,bhcqs,bcshp->bcqhp", scores, L, Xc)

    # 2. per-chunk final states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)         # [B,H,nc,Q]
    states = torch.einsum("bcqhn,bhcq,bcqhp->bchpn", Bh, decay_states, Xc)

    # 3. inter-chunk recurrence over nc (tiny loop)
    chunk_decay = torch.exp(A_cum[..., -1])                   # [B,H,nc]
    h = initial_state
    if h is None:
        h = torch.zeros((B, H, P, N), dtype=torch.float32, device=X.device)
    h_prevs = []
    for k in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, :, k, None, None] + states[:, k]
    h_prevs = torch.stack(h_prevs, dim=1)                     # [B,nc,H,P,N]

    # 4. off-diagonal contribution from the carried state
    state_decay = torch.exp(A_cum)                            # [B,H,nc,Q]
    Y_off = torch.einsum("bcqhn,bchpn,bhcq->bcqhp", Ch, h_prevs, state_decay)

    Y = (Y_diag + Y_off).reshape(B, S_p, H, P)[:, :S]
    return Y, h
