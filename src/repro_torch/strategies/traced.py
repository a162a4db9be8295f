"""The device-selection policies with fixed-size results, for the
device-resident round (``repro.strategies.traced``).

Each returns ``(idx, mask)`` of a static length (the selector's
``pad_size``):

* ``idx`` is int64; padding lanes hold the sentinel ``num_devices``. The
  round gathers client data at ``min(idx, N − 1)``, as JAX clamps a
  gather, and writes a padding lane's row into a row of the plane that is
  never read, as JAX drops an out-of-bounds scatter.
* ``mask`` is True exactly on the real lanes: it zeroes the padding lanes'
  aggregation weights and keeps them out of the allocators' reductions.

Top-k is a stable descending sort, so ties go to the lower index as in
``lax.top_k`` (``torch.topk`` does not promise that). A NaN score (the
divergence of a non-finite row: a byzantine row past fp32's range, or a
training blow-up) ranks last, below −inf: ``lax.top_k`` orders floats
totally and puts the NaN that x86 arithmetic makes (its sign bit set)
there, where ``torch.sort`` would rank it first and mask its cluster.
Every NaN ranks last here, whatever its sign, so the card (whose
arithmetic NaN is positive) ranks it as the CPU does. The stochastic
policies take their random input as a tensor — ``[N]`` uniforms, or a
permutation of N for ``random`` — so a caller decides where it comes from
and a test can feed the reference's ``jax.random`` draws; nothing draws
inside. The host versions (``repro_torch.core.selection``) stay the
round-at-a-time loop's.

Every policy also takes a leading lane axis (a cohort's seeds, where the
reference ``vmap``s): divergences, labels, draws and fleet arrays of
``[B, N]`` give ``idx``/``mask`` of ``[B, pad]``, each lane the selection
its own inputs give alone.

Under the buffered-asynchronous engine's churn the fleet arrays carry an
``avail`` mask (1.0 / 0.0, ``repro_torch.core.async_engine``): the
divergence and ICAS policies sink an unavailable device's score to −inf,
so it wins no slot (the stable sort keeps −inf last, and a −inf winner
is marked invalid), and stochastic scheduling gives it probability 0.
Without the key each policy is the program it was.
"""
from __future__ import annotations

import torch

from repro_torch.core.wireless import (device_scalar, effective_arrays,
                                       rate_mbps)


def _stable_top(scores: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis,
    descending, the lower index first on ties (``lax.top_k``), a NaN
    below −inf. The sort runs on fp32's bits as ordered integers (a
    negative float's magnitude bits flipped), a NaN's key the least."""
    bits = scores.to(torch.float32).view(torch.int32)
    key = torch.bitwise_xor(bits, torch.bitwise_and(bits >> 31, 0x7FFFFFFF))
    key = torch.where(torch.isnan(scores), torch.iinfo(torch.int32).min,
                      key)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return torch.gather(scores, -1, order), order


def rate_at(arr, band_mhz: float) -> torch.Tensor:
    """Each device's rate [Mbit/s] at an equal band share ``band_mhz``."""
    return rate_mbps(device_scalar(band_mhz, arr["J"].device), arr["J"])


def _participants(mask: torch.Tensor, fallback: torch.Tensor, n: int):
    """``(idx, mask)`` over all N lanes from a participation mask, never
    empty: with nobody drawn, the device ``argmax(fallback)`` alone (per
    lane of a leading lane axis)."""
    lanes = torch.arange(n, device=mask.device)
    mask = torch.where(torch.any(mask, dim=-1, keepdim=True), mask,
                       lanes == torch.argmax(fallback, dim=-1, keepdim=True))
    return torch.where(mask, lanes, n), mask


def _per_cluster_topk(scores, labels, num_clusters: int, s: int,
                      num_devices: int):
    """Top-``s`` lanes per cluster of a score vector.

    Returns ``(idx, mask)`` of static length ``num_clusters * s`` (after
    the lane axis, if any); clusters with fewer than ``s`` members pad
    with the sentinel. Cluster blocks come in label order (the host loop's
    concatenation order), each block descending by score.
    """
    clusters = torch.arange(num_clusters, device=labels.device)
    member = labels[..., None, :] == clusters[:, None]        # [.., c, N]
    masked = torch.where(member, scores[..., None, :].to(torch.float32),
                         -float("inf"))
    top, order = _stable_top(masked, s)                       # [.., c, s]
    valid = torch.isfinite(top)
    idx = torch.where(valid, order, num_devices)
    lead = idx.shape[:-2]
    return idx.reshape(lead + (-1,)), valid.reshape(lead + (-1,))


def _sink_unavailable(scores, avail):
    """``scores`` with the devices ``avail`` marks gone at −inf."""
    return torch.where(avail > 0.0, scores,
                       torch.full_like(scores, -float("inf")))


def select_divergence_traced(divergences, labels, *, num_clusters: int,
                             s: int, num_devices: int, avail=None):
    """Algorithm 4: the top-s weight divergence of each cluster; under
    churn (``avail``) of its available devices only."""
    if avail is not None:
        divergences = _sink_unavailable(divergences, avail)
    return _per_cluster_topk(divergences, labels, num_clusters, s,
                             num_devices)


def select_kmeans_random_traced(uniforms, labels, *, num_clusters: int,
                                s: int, num_devices: int):
    """Algorithm 3: s uniform devices of each cluster — the top-s of
    ``[N]`` uniform scores in a cluster are a draw without replacement."""
    return _per_cluster_topk(uniforms, labels, num_clusters, s, num_devices)


def select_random_traced(permutation, *, num_devices: int, S: int):
    """FedAvg: the first S of a permutation of the N devices."""
    idx = permutation[..., :S].to(torch.int64)
    return idx, torch.ones(idx.shape, dtype=torch.bool, device=idx.device)


def select_icas_traced(divergences, arr, *, bandwidth_mhz: float,
                       num_devices: int, S: int, beta: float):
    """ICAS: importance × channel rate, a geometric blend; the top S.
    Under churn (``arr["avail"]``) the unavailable devices score −inf, and
    only finite winners stay valid (the rest point at the sentinel N)."""
    avail = arr.get("avail")
    arr = effective_arrays(arr)
    rates = rate_at(arr, bandwidth_mhz / num_devices)
    u = divergences / torch.clamp(
        torch.amax(divergences, dim=-1, keepdim=True), min=1e-12)
    r = rates / torch.clamp(torch.amax(rates, dim=-1, keepdim=True),
                            min=1e-12)
    score = torch.pow(u, beta) * torch.pow(r, 1.0 - beta)
    if avail is None:
        _, idx = _stable_top(score, S)
        return idx, torch.ones(idx.shape, dtype=torch.bool,
                               device=idx.device)
    top, idx = _stable_top(_sink_unavailable(score, avail), S)
    valid = torch.isfinite(top)
    return torch.where(valid, idx, num_devices), valid


def select_stochastic_sched_traced(uniforms, arr, *, bandwidth_mhz: float,
                                   num_devices: int, S: int):
    """Churn-aware stochastic scheduling (Perazzone et al., arXiv
    2201.07912): each device joins independently with a probability
    proportional to its energy headroom over its per-round cost,
    normalised to an expected set size of S; never empty. N lanes. Under
    churn (``arr["avail"]``) an unavailable device's ratio is 0: it is
    never drawn."""
    avail = arr.get("avail")
    arr = effective_arrays(arr)
    cost = (arr["H"] / rate_at(arr, bandwidth_mhz / S)
            + arr["G"] * torch.square(arr["f_max"]))
    ratio = arr["e_cons"] / torch.clamp(cost, min=1e-12)
    if avail is not None:
        ratio = ratio * avail
    total = torch.sum(ratio, dim=-1, keepdim=True)
    p = torch.clamp(S * ratio / torch.clamp(total, min=1e-12), 0.0, 1.0)
    return _participants(uniforms < p, ratio, num_devices)


def select_rra_traced(uniforms, arr, *, bandwidth_mhz: float,
                      num_devices: int, target_mean: int):
    """RRA: energy-efficiency thresholding over N lanes — the set size
    varies through the mask, not the shape. ``jnp.percentile`` is
    ``torch.quantile``: both interpolate linearly."""
    arr = effective_arrays(arr)
    e_eq = arr["H"] / rate_at(arr, bandwidth_mhz / target_mean)
    eff = arr["e_cons"] / torch.clamp(e_eq, min=1e-12)
    q = min(1.0, target_mean / num_devices)
    p = torch.clamp(eff / torch.quantile(eff, q, dim=-1, keepdim=True),
                    0.0, 1.0)
    total = torch.sum(p, dim=-1, keepdim=True)
    scale = torch.clamp(target_mean / torch.clamp(total, min=1e-9), max=1.0)
    return _participants(uniforms < p * scale, eff, num_devices)
