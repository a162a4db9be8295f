"""Plain reference of the paper's FL round with the CNN (Fig. 3, Algs.
1-5): plain PyTorch in float32 (the caller keeps TF32 off), a client at
a time, and the float64 SAO of ``reference/sao.py``.

The model is NHWC images, HWIO convolution weights and ``[din, dout]``
linear weights (the port's layout), run through ``conv2d`` and
``max_pool2d``; a flat row is the leaves in sorted name order (the port's
flat plane). Imports only torch, NumPy and the reference's own modules.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import sao


class Layout:
    """The flat row of a model: its leaves in sorted name order."""

    def __init__(self, shapes: Dict[str, tuple]):
        self.names = sorted(shapes)
        self.shapes = {k: tuple(shapes[k]) for k in self.names}
        self.sizes = [math.prod(self.shapes[k]) for k in self.names]
        self.total = sum(self.sizes)

    def flatten(self, params) -> torch.Tensor:
        return torch.cat([params[k].reshape(-1) for k in self.names])

    def unflatten(self, row: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, at = {}, 0
        for k, n in zip(self.names, self.sizes):
            out[k] = row[at:at + n].reshape(self.shapes[k])
            at += n
        return out

    def columns(self, name: str) -> slice:
        at = sum(n for k, n in zip(self.names, self.sizes) if k < name)
        return slice(at, at + self.sizes[self.names.index(name)])


def forward(p, x: torch.Tensor, pool: int) -> torch.Tensor:
    """Logits of images ``x`` [B, H, W, C]."""
    h = x.permute(0, 3, 1, 2)
    for w, b in (("w_c1", "b_c1"), ("w_c2", "b_c2")):
        h = F.max_pool2d(F.relu(F.conv2d(h, p[w].permute(3, 2, 0, 1),
                                         p[b])), pool)
    h = h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    h = F.relu(h @ p["w_fc1"] + p["b_fc1"])
    return h @ p["w_fc2"] + p["b_fc2"]


def local_sgd(layout: Layout, gvec, images, labels, batch_idx, lr: float,
              pool: int) -> torch.Tensor:
    """Clients' L SGD steps from the global row, each on its own shard:
    ``images [k, D, ...]``, ``labels [k, D]``, step t of client i on the
    samples ``batch_idx[i, t]``, the mean cross-entropy. The ``[k, P]``
    new rows. The clients' gradients are one call a step
    (``torch.func.vmap`` of ``torch.func.grad``)."""
    from torch.func import grad, vmap

    def loss(p, x, y):
        return F.cross_entropy(forward(p, x, pool), y)

    step_grad = vmap(grad(loss))
    k = images.shape[0]
    p = {n: v.expand((k,) + v.shape).clone()
         for n, v in layout.unflatten(gvec).items()}
    lanes = torch.arange(k, device=images.device)[:, None]
    for t in range(batch_idx.shape[1]):
        idx = batch_idx[:, t]
        g = step_grad(p, images[lanes, idx], labels[lanes, idx].long())
        p = {n: p[n] - lr * g[n] for n in p}
    return torch.cat([p[n].reshape(k, -1) for n in layout.names], dim=1)


#: a test image whose two largest logits lie closer than this share of the
#: test set's largest |logit| may go either way between two float32
#: forward passes (the logits are sums that cancel: their rounding
#: follows the scale of the terms, not of the image's own logits)
NEAR_TIE = 1e-4


def accuracy(layout: Layout, gvec, test_x, test_y, pool: int):
    """``(low, high)``: the test accuracy of the row ``gvec`` with each
    near tie (``NEAR_TIE``) between the label and another class counted
    wrong, and counted right."""
    with torch.no_grad():
        logits = forward(layout.unflatten(gvec), test_x, pool).double()
    top = torch.topk(logits, 2, dim=1)
    y = test_y.long()
    near = (top.values[:, 0] - top.values[:, 1]
            < NEAR_TIE * logits.abs().amax())
    right = top.indices[:, 0] == y
    low = right & ~near
    high = right | (near & (top.indices[:, 1] == y))
    return float(low.double().mean()), float(high.double().mean())


def fold(rows: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """Eq. (4): the weighted mean of the ``[k, P]`` rows, in float64, as
    float32."""
    w = torch.as_tensor(np.asarray(weights, np.float64), device=rows.device)
    return ((w[:, None] * rows.double()).sum(0) / w.sum()).float()


def select(div: np.ndarray, labels: np.ndarray, clusters: int, per: int,
           n: int):
    """Alg. 4: in each cluster in label order the ``per`` largest
    divergences, descending, the lower index first on a tie; a cluster
    short of members pads with the sentinel ``n``. ``(lanes, mask)``."""
    lanes, mask = [], []
    for c in range(clusters):
        members = [int(i) for i in np.flatnonzero(labels == c)]
        members.sort(key=lambda i: (-div[i], i))
        for t in range(per):
            lanes.append(members[t] if t < len(members) else n)
            mask.append(t < len(members))
    return np.array(lanes), np.array(mask)


def fleet_subset(fleet: dict, idx) -> dict:
    return {k: v[np.asarray(idx)] for k, v in fleet.items()}


class Lane:
    """One seed's run as the reference follows it: the data, the fleet
    and the experiment's settings (``fl``: the configuration's ``fl``)."""

    def __init__(self, layout: Layout, fl: dict, pool: int, images, labels,
                 sizes, test_x, test_y, fleet: dict, device):
        self.layout, self.fl, self.pool = layout, fl, pool
        self.images = torch.as_tensor(images, device=device)
        self.labels = torch.as_tensor(labels, device=device)
        self.sizes = np.asarray(sizes, np.float64)
        self.test_x = torch.as_tensor(test_x, device=device)
        self.test_y = torch.as_tensor(test_y, device=device)
        self.fleet = fleet

    def train(self, gvec, clients, batch_idx) -> torch.Tensor:
        """The ``[k, P]`` rows of ``clients`` after local SGD on
        ``batch_idx [k, L, batch]``."""
        idx = torch.as_tensor(np.asarray(clients), device=self.images.device)
        return local_sgd(self.layout, gvec, self.images[idx],
                         self.labels[idx], batch_idx,
                         self.fl["learning_rate"], self.pool)

    def initial_round(self, gvec, batch0, allocate: bool = True):
        """All devices train and fold; with ``allocate`` SAO over all N.
        ``(plane, new row, T, E)``."""
        n = self.fl["clients"]
        rows = self.train(gvec, np.arange(n), batch0)
        g = fold(rows, self.sizes)
        T = E = None
        if allocate:
            T, E, _, _ = sao.solve(self.fleet, self.fl["bandwidth_mhz"])
        return rows, g, T, E

    def selection_gap(self, gvec, plane, labels: np.ndarray, got) -> float:
        """How far a program's selection ``got`` (its clients in lane
        order) falls short of Alg. 4 on the row ``gvec`` and plane
        ``plane``: the largest (top − picked) / top divergence over the
        clusters; 1 for a pick from another cluster or another number of
        lanes."""
        fl = self.fl
        div = torch.sqrt(((plane.double() - gvec.double()) ** 2).sum(1))
        div = div.cpu().numpy()
        lanes, mask = select(div, labels, fl["num_clusters"],
                             fl["selected_per_cluster"], fl["clients"])
        want, got = lanes[mask], np.asarray(got, np.int64)
        if len(want) != len(got):
            return 1.0
        gap = 0.0
        for w, g in zip(want, got):
            if labels[g] != labels[w]:
                return 1.0
            gap = max(gap, (div[w] - div[g]) / div[w])
        return float(gap)

    def live_lanes(self, labels: np.ndarray) -> np.ndarray:
        """The lanes of a round's selection that hold a client: one a
        non-empty cluster (``selected_per_cluster`` a cluster at most)."""
        fl = self.fl
        _, mask = select(np.zeros(fl["clients"]), labels, fl["num_clusters"],
                         fl["selected_per_cluster"], fl["clients"])
        return np.flatnonzero(mask)

    def allocate(self, sel, lanes: int):
        """SAO over the clients ``sel`` of a round of ``lanes`` lanes:
        ``(T, E)``."""
        T, E, _, _ = sao.solve(fleet_subset(self.fleet, sel),
                               self.fl["bandwidth_mhz"], lanes=lanes)
        return T, E

    def accuracy(self, gvec):
        return accuracy(self.layout, gvec, self.test_x, self.test_y,
                        self.pool)

    def fold(self, rows: torch.Tensor, sel) -> torch.Tensor:
        return fold(rows, self.sizes[np.asarray(sel)])


def kmeans_gap(features: torch.Tensor, labels: np.ndarray) -> float:
    """How far ``labels`` are from a converged Lloyd assignment of
    ``features``: the largest (d(x, own centroid) − d(x, nearest
    centroid)) / d(x, nearest centroid) over the rows, the centroids the
    means of the labelled clusters (the non-empty ones), in float64. 0 at
    a fixed point."""
    x = features.double()
    lab = torch.as_tensor(labels, device=x.device)
    ids = sorted(set(int(v) for v in labels))
    cent = torch.stack([x[lab == c].mean(0) for c in ids])
    d = torch.cdist(x, cent) ** 2
    own = d[torch.arange(x.shape[0]), torch.as_tensor(
        [ids.index(int(v)) for v in labels], device=x.device)]
    near = d.min(1).values
    return float(((own - near) / near.clamp(min=1e-300)).max())
