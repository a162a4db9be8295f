"""Plain reference of the paper's round over whole LM clients, in float64
on the clients' device, a block of columns at a time so that it fits
beside the clients:

  1. divergence ‖w_n − w_g‖ of each client over every leaf;
  2. the K-means label of each client's feature block: its nearest
     centroid, the first on a tie;
  3. in each cluster the client of the largest divergence (the first on a
     tie; an empty cluster selects nobody);
  4. the new global model: the winners' data-size-weighted mean.

:func:`check_round` holds a program's outputs to it; :func:`lower_round`
is the control: the same round with the clients and the global model
rounded to fp8 (e4m3, a scale a leaf), its result in the model's type.
Imports only torch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

BLOCK = 1 << 23          # columns a block (16 clients: 1 GiB of float64)


def _blocks(f: int, block: int):
    for s in range(0, f, block):
        yield s, min(s + block, f)


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(n, -1)


def divergence(clients, glob, block: int = BLOCK) -> torch.Tensor:
    """``[N]`` float64 ‖w_n − w_g‖ over every leaf."""
    names = list(clients)
    n = clients[names[0]].shape[0]
    sq = torch.zeros(n, dtype=torch.float64, device=clients[names[0]].device)
    for k in names:
        x, g = _rows(clients[k], n), glob[k].reshape(-1)
        for s, e in _blocks(x.shape[1], block):
            d = x[:, s:e].double() - g[s:e].double()
            sq += (d * d).sum(dim=1)
    return sq.sqrt()


def labels_of(feats: torch.Tensor, cent: torch.Tensor,
              block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(labels [N], distances [N, c])``: each row's nearest centroid by
    the float64 squared distance, the first on a tie."""
    n, c = feats.shape[0], cent.shape[0]
    dist = torch.zeros((n, c), dtype=torch.float64, device=feats.device)
    for s, e in _blocks(feats.shape[1], block):
        x = feats[:, s:e].double()
        for j in range(c):
            d = x - cent[j, s:e].double()
            dist[:, j] += (d * d).sum(dim=1)
    return torch.argmin(dist, dim=1), dist


def winners(div: torch.Tensor, labels: torch.Tensor, clusters: int):
    """The client of the largest divergence in each non-empty cluster (the
    first on a tie), in cluster order."""
    out = []
    for c in range(clusters):
        members = torch.nonzero(labels == c).flatten().tolist()
        if members:
            vals = [float(div[i]) for i in members]
            out.append(members[vals.index(max(vals))])
    return out


def fold_weights(win, sizes: torch.Tensor, n: int) -> torch.Tensor:
    w = torch.zeros(n, dtype=torch.float64, device=sizes.device)
    for i in win:
        w[i] = float(sizes[i])
    return w / max(float(w.sum()), 1e-9)


def feature_rows(clients, n: int) -> torch.Tensor:
    return _rows(clients["lm_head"] if "lm_head" in clients
                 else clients["embed"], n)


def check_round(clients, glob, cent, sizes, clusters: int, got,
                block: int = BLOCK) -> Dict[str, float]:
    """The round from ``glob`` against a program's ``got = (new_global,
    div, labels)``: the largest relative gap of a divergence, the labels
    and the winners that differ, each leaf's ‖got − ref‖₂ / ‖ref‖₂ of the
    new global model (the worst leaf), and the leaves whose type is not
    the global model's."""
    new_g, div_got, lab_got = got
    names = list(clients)
    n = clients[names[0]].shape[0]
    div = divergence(clients, glob, block)
    labels, _ = labels_of(feature_rows(clients, n), cent, block)
    win = winners(div, labels, clusters)
    win_got = winners(div_got.to(div.device).double(),
                      lab_got.to(labels.device), clusters)
    w = fold_weights(win, sizes, n)
    fold_gap = 0.0
    for k in names:
        x, out = _rows(clients[k], n), new_g[k].reshape(-1)
        num = den = 0.0
        for s, e in _blocks(x.shape[1], block):
            ref = torch.zeros(e - s, dtype=torch.float64, device=x.device)
            for i in win:
                ref += w[i] * x[i, s:e].double()
            d = out[s:e].to(x.device).double() - ref
            num += float((d * d).sum())
            den += float((ref * ref).sum())
        fold_gap = max(fold_gap, (num / max(den, 1e-300)) ** 0.5)
    div_gap = float(torch.max(torch.abs(div_got.to(div.device).double() - div)
                              / div))
    return {"div_gap": div_gap,
            "labels_differ": float(torch.sum(lab_got.to(labels.device)
                                             != labels)),
            "winners_differ": float(len(set(win) ^ set(win_got))),
            "fold_gap": fold_gap,
            "dtype_differ": float(sum(new_g[k].dtype != glob[k].dtype
                                      for k in names))}


def _amax(t: torch.Tensor, block: int) -> float:
    flat = t.reshape(-1)
    return max(float(flat[s:s + block].abs().amax())
               for s in range(0, flat.numel(), block))


def _fp8(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 at ``scale`` (widened back to fp32)."""
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


def lower_round(clients, glob, cent, sizes, clusters: int,
                block: int = BLOCK):
    """The control: the round computed from the clients and the global
    model rounded to fp8 e4m3 (one scale a leaf, its largest magnitude at
    448), the sums in float32; ``(new_global in the model's type, div
    [N], labels [N])``."""
    names = list(clients)
    n = clients[names[0]].shape[0]
    dev = clients[names[0]].device
    scale = {k: max(_amax(clients[k], block), _amax(glob[k], block),
                    1e-30) / 448.0 for k in names}
    sq = torch.zeros(n, dtype=torch.float32, device=dev)
    for k in names:
        x, g = _rows(clients[k], n), glob[k].reshape(-1)
        for s, e in _blocks(x.shape[1], block):
            d = _fp8(x[:, s:e], scale[k]) - _fp8(g[s:e], scale[k])
            sq += (d * d).sum(dim=1)
    div = sq.sqrt()
    feat_name = "lm_head" if "lm_head" in clients else "embed"
    feats = feature_rows(clients, n)
    dist = torch.zeros((n, cent.shape[0]), dtype=torch.float32, device=dev)
    for s, e in _blocks(feats.shape[1], block):
        x = _fp8(feats[:, s:e], scale[feat_name])
        for j in range(cent.shape[0]):
            d = x - cent[j, s:e].float()
            dist[:, j] += (d * d).sum(dim=1)
    labels = torch.argmin(dist, dim=1)
    win = winners(div.double(), labels, clusters)
    w = fold_weights(win, sizes, n).float()
    new_g = {}
    for k in names:
        x = _rows(clients[k], n)
        out = torch.empty(x.shape[1], dtype=glob[k].dtype, device=dev)
        for s, e in _blocks(x.shape[1], block):
            acc = torch.zeros(e - s, dtype=torch.float32, device=dev)
            for i in win:
                acc += w[i] * _fp8(x[i, s:e], scale[k])
            out[s:e] = acc.to(glob[k].dtype)
        new_g[k] = out.reshape(glob[k].shape)
    return new_g, div, labels
