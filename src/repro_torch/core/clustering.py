"""K-means device clustering — paper §IV-A/B, Algorithms 2-3.

The paper trains K-means on the weights of one late layer (``w_fc2``):
faster (feature dim 2240 vs 113744) and more telling of a client's majority
class than all weights (Fig. 4/8/9). Lloyd iterations with k-means++
seeding, all on the features' device; the seeding choices come from the
caller's draws object (``repro_torch.core.draws``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.utils.trees import StackFlattenSpec, tree_order


def _resolve_flat_layer(spec: StackFlattenSpec, layer: str):
    """A leaf name as given, else the first leaf whose ``/``-path ends in
    it (``"wv_b"`` -> ``"blocks/attn/wv_b"``), else ``None``."""
    if layer in spec.names:
        return layer
    hits = [n for n in spec.names if n.endswith("/" + layer)]
    return hits[0] if hits else None


def resolve_feature_columns(spec: StackFlattenSpec, layer: str):
    """The feature layer's column slice of a flat row (``None`` = the whole
    row, i.e. ``layer="all"``). ``"auto"`` is the paper's ``w_fc2``, else
    ``lm_head``, else the last leaf; a bare leaf name resolves through
    nested paths as in the reference."""
    if layer == "all":
        return None
    if layer == "auto":
        layer = (_resolve_flat_layer(spec, "w_fc2")
                 or _resolve_flat_layer(spec, "lm_head")
                 or spec.names[-1])
    else:
        resolved = _resolve_flat_layer(spec, layer)
        if resolved is None:
            raise KeyError(layer)
        layer = resolved
    return spec.columns(layer)


def extract_features(stacked_params, layer: str = "auto") -> torch.Tensor:
    """Feature matrix ``[N, F]`` from client-stacked leaves ``{name: [N,
    ...]}``: ``"all"`` flattens every leaf (the slow baseline of Fig. 8),
    ``"auto"`` takes ``w_fc2``, else ``lm_head``, else the last leaf, and
    a leaf name (bare or ``/``-joined) takes that leaf. Leaves go in the
    reference's flatten order (:func:`tree_order`)."""
    names = tree_order(stacked_params)

    def rows(name):
        leaf = stacked_params[name]
        return leaf.reshape(leaf.shape[0], -1).to(torch.float32)

    if layer == "all":
        return torch.cat([rows(n) for n in names], dim=1)
    if layer == "auto":
        hit = [n for n in ("w_fc2", "lm_head") if n in stacked_params]
        return rows(hit[0] if hit else names[-1])
    if layer in stacked_params:
        return rows(layer)
    hits = [n for n in names if n.endswith("/" + layer)]
    if not hits:
        raise KeyError(layer)
    return rows(hits[0])


def extract_features_flat(client_flat: torch.Tensor, layer: str,
                          spec: StackFlattenSpec) -> torch.Tensor:
    """Feature matrix from the ``[N, P]`` plane: a zero-copy column slice
    (``layer="all"`` is the plane itself)."""
    cols = resolve_feature_columns(spec, layer)
    return client_flat if cols is None else client_flat[:, cols]


def kmeans_plus_plus_init(x: torch.Tensor, c: int, draws) -> torch.Tensor:
    """k-means++ seeding: the first centroid is ``draws.kmeans_seed``, each
    next one ``draws.kmeans_choice`` with probability ∝ the squared
    distance to the nearest centroid chosen so far."""
    n = x.shape[0]

    def row(idx):       # a device-side gather: no read-back of the index
        return x.index_select(0, idx.reshape(1).to(x.device))[0]

    centroids = torch.zeros((c, x.shape[1]), dtype=x.dtype, device=x.device)
    centroids[0] = row(draws.kmeans_seed(n, c))
    cols = torch.arange(c, device=x.device)
    for i in range(1, c):
        d = ops.pairwise_sq_dists(x, centroids)
        # unchosen centroids are zero rows: only the first i columns count
        d = torch.where((cols < i)[None, :], d,
                        torch.full_like(d, float("inf")))
        dmin = torch.min(d, dim=1).values
        p = dmin / torch.clamp(torch.sum(dmin), min=1e-12)
        centroids[i] = row(draws.kmeans_choice(i, p))
    return centroids


def kmeans_fit(x: torch.Tensor, c: int, iters: int = 50, *, draws=None,
               init_centroids: torch.Tensor = None):
    """Lloyd's algorithm, eqs (13)-(14), from k-means++ seeds (``draws``)
    or from ``init_centroids``. Returns (centroids, labels, inertia).
    ``torch.argmin`` takes the first index on ties, like ``jnp.argmin``."""
    x = x.to(torch.float32).contiguous()
    if init_centroids is not None:
        centroids = init_centroids.to(device=x.device, dtype=torch.float32)
    elif draws is not None:
        centroids = kmeans_plus_plus_init(x, c, draws)
    else:
        raise ValueError("kmeans_fit needs draws (k-means++ seeding) or "
                         "init_centroids")
    for _ in range(iters):
        labels = torch.argmin(ops.pairwise_sq_dists(x, centroids), dim=1)
        onehot = torch.nn.functional.one_hot(labels, c).to(torch.float32)
        counts = onehot.sum(dim=0)
        new = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
        # an empty cluster keeps its old centroid
        centroids = torch.where((counts > 0)[:, None], new, centroids)
    d = ops.pairwise_sq_dists(x, centroids)
    labels = torch.argmin(d, dim=1)
    return centroids, labels, torch.sum(torch.min(d, dim=1).values)


def kmeans_predict(centroids: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The nearest centroid of each row of ``x`` (first index on ties),
    through the ``pairwise_l2`` kernel on the card."""
    return torch.argmin(ops.pairwise_sq_dists(x.to(torch.float32),
                                              centroids), dim=1)


def _chunk_assign_stats(x: torch.Tensor, centroids: torch.Tensor, c: int):
    """One chunk's Lloyd-pass statistics: (per-cluster feature sums
    ``[C, F]``, per-cluster counts ``[C]``, the chunk's inertia)."""
    d = ops.pairwise_sq_dists(x, centroids)
    labels = torch.argmin(d, dim=1)
    onehot = torch.nn.functional.one_hot(labels, c).to(torch.float32)
    return (onehot.T @ x, onehot.sum(dim=0),
            torch.sum(torch.min(d, dim=1).values))


def kmeans_fit_minibatch(chunks, c: int, iters: int = 50, *, draws,
                         device="cpu"):
    """Lloyd's algorithm over a feature stream, O(chunk) in memory.

    ``chunks`` is a CALLABLE returning a fresh iterator of ``[n_i, F]``
    feature blocks (host arrays or tensors; the paged experiment's
    ``iter_client_features``), so the ``[N, F]`` matrix never exists:
    each pass folds every chunk's assignment sums and counts into ``[C,
    F]`` accumulators and moves the centroids once — full-batch Lloyd,
    a chunk at a time, on ``device``.

    A SINGLE-chunk stream is :func:`kmeans_fit` verbatim (the small
    fleet's pin); a stream of several seeds k-means++ (``draws``) on its
    first chunk only. Returns ``(centroids, labels, inertia)``, the labels
    of every streamed row in stream order."""
    def load(block):
        return torch.as_tensor(block, dtype=torch.float32).contiguous().to(
            device)

    first = None
    multi = False
    for block in chunks():
        if first is None:
            first = load(block)
        else:
            multi = True
            break
    if first is None:
        raise ValueError("kmeans_fit_minibatch: empty feature stream")
    if not multi:
        return kmeans_fit(first, c, iters, draws=draws)

    centroids = kmeans_plus_plus_init(first, c, draws)
    for _ in range(iters):
        sums = torch.zeros_like(centroids)
        counts = torch.zeros((c,), dtype=torch.float32, device=first.device)
        for block in chunks():
            s, n, _ = _chunk_assign_stats(load(block), centroids, c)
            sums = sums + s
            counts = counts + n
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        centroids = torch.where((counts > 0)[:, None], new, centroids)

    labels, inertia = [], 0.0
    for block in chunks():
        d = ops.pairwise_sq_dists(load(block), centroids)
        labels.append(torch.argmin(d, dim=1))
        inertia += float(torch.sum(torch.min(d, dim=1).values))
    return centroids, torch.cat(labels), inertia


def clusters_from_labels(labels, c: int):
    """Algorithm 2 output form: list of index arrays {N_1..N_c}."""
    labels = np.asarray(labels.cpu() if isinstance(labels, torch.Tensor)
                        else labels)
    return [np.flatnonzero(labels == i) for i in range(c)]


def adjusted_rand_index(pred: np.ndarray, truth: np.ndarray) -> float:
    """Standard ARI (Hubert & Arabie 1985) — the paper's eq. (24) metric."""
    pred = np.asarray(pred)
    truth = np.asarray(truth)
    n = len(pred)
    pv, pi = np.unique(pred, return_inverse=True)
    tv, ti = np.unique(truth, return_inverse=True)
    cont = np.zeros((len(pv), len(tv)), np.int64)
    np.add.at(cont, (pi, ti), 1)
    comb = lambda v: v * (v - 1) / 2.0
    sum_ij = comb(cont).sum()
    a = comb(cont.sum(axis=1)).sum()
    b = comb(cont.sum(axis=0)).sum()
    expected = a * b / comb(n)
    max_index = 0.5 * (a + b)
    if max_index == expected:
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))
