"""Plain PyTorch versions of the hand-written kernels (the correctness
ground truth). Written in the most naive correct form, so a kernel test
compares two independent implementations; a kernel wrapper takes these
for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch


def pairwise_l2_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances. x: [N, F]; c: [M, F] -> [N, M] fp32,
    or one such per lane of a leading lane axis ([B, N, F] × [B, M, F] ->
    [B, N, M]). The direct difference form, O(N·M·F) memory."""
    diff = (x.to(torch.float32)[..., :, None, :]
            - c.to(torch.float32)[..., None, :, :])
    return torch.sum(torch.square(diff), dim=-1)


def flat_aggregate_ref(flat: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Weighted row sum over the flat client plane: [N, P] × [N] -> [P] fp32
    (or [B, N, P] × [B, N] -> [B, P] over a leading lane axis), as an
    elementwise multiply + row-axis reduce (not a dot)."""
    w = weights.to(torch.float32)
    return torch.sum(flat.to(torch.float32) * w[..., None], dim=-2)


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """Plain softmax attention. q: [B, H, Sq, D]; k, v: [B, H, Sk, D].
    Queries are right-aligned to keys; a row with no unmasked key gives NaN
    (``softmax`` of all ``-inf``), as the reference's oracle does."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / torch.sqrt(
                              torch.tensor(float(D)))
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def ssd_ref(X, A, Bm, Cm):
    """Token-by-token SSD recurrence. X: [B, S, H, P] (pre-scaled by dt);
    A: [B, S, H] log-decay; Bm, Cm: [B, S, H, N] (already head-expanded).
    Returns (Y [B, S, H, P], h [B, H, P, N]):

      h_t = exp(A_t)·h_{t-1} + X_t ⊗ B_t ;   y_t = h_t · C_t
    """
    B, S, H, P = X.shape
    N = Bm.shape[-1]
    X, Bm, Cm = (t.to(torch.float32) for t in (X, Bm, Cm))
    decay = torch.exp(A.to(torch.float32))[..., None, None]   # [B,S,H,1,1]
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=X.device)
    ys = []
    for t in range(S):       # three ops a step (the backward is a loop too)
        h = torch.addcmul(h * decay[:, t], X[:, t, :, :, None],
                          Bm[:, t, :, None, :])
        ys.append(torch.matmul(h, Cm[:, t, :, :, None])[..., 0])
    return torch.stack(ys, dim=1), h
