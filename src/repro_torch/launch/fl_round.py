"""The paper's FL round over whole LM clients (the port of
``repro.launch.fl_round.fl_round_step``): N client models stacked on a
leading axis, one round =

  1. weight divergence ‖w_n − w_g‖ of every client over all its weights
     (§IV-C, the Alg. 4 signal);
  2. K-means assignment of a late-layer feature block (``lm_head``, or
     the tied ``embed``) to given centroids (Alg. 2/3);
  3. the top-1-divergence client of each cluster selected (Alg. 4);
  4. the D_n-weighted FedAvg fold over the selected clients (eq. 4).

It runs on the device the clients lie on, through ``kernels.ops``: on the
card the divergence is ``pairwise_l2``'s one-centroid kernel and the fold
``flat_aggregate``'s, leaf by leaf, each reading a bf16 model's rows as
they are (no widened copy of the ``[N, P]`` clients); the K-means
distances are ``pairwise_l2`` against the centroids. On the CPU the same
ops take their plain versions.

``lower_fl_round`` lays the round out on a mesh as the reference does:
``N`` stacked copies of an architecture's parameters as ``meta`` structs,
the client axis over the mesh's batch axes and each leaf's own spec
behind it; the result counts the round (``cost_analysis``) and, on a
one-device host mesh, compiles to :func:`fl_round_step` itself. On a host
mesh of ``data = d > 1`` positions it compiles to :func:`fl_round_split`,
the clients split over the positions (the reference's ``batch_axes``).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import Mesh
from repro_torch.roofline.analysis import Lowered
from repro_torch.sharding import specs as sh
from repro_torch.utils.spans import span
from repro_torch.utils.trees import tree_order

Params = Dict[str, torch.Tensor]


def fl_round_step(client_params: Params, global_params: Params,
                  centroids: torch.Tensor, sizes: torch.Tensor, *,
                  num_clusters: int, feature_slice: int = 0
                  ) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """One round over stacked clients. ``client_params``: the port's flat
    dict of ``[N, ...]`` leaves; ``global_params``: the same names
    unstacked; ``centroids``: ``[c, F]`` K-means centroids on the feature
    layer (its first ``feature_slice`` columns where that is > 0);
    ``sizes``: ``[N]`` the clients' data sizes D_n.

    Returns ``(new_global, divergence [N] fp32, labels [N] int64)``:
    leaves are widened to fp32 for every sum, and ``new_global`` comes
    back in each global leaf's dtype, as in the reference. Selection keeps
    the reference's arithmetic: non-members masked at -1e30, the first
    client on a tie (``argmax``), an empty cluster selecting nobody, the
    fold's weight sum clamped at 1e-9."""
    names = tree_order(client_params)
    n = client_params[names[0]].shape[0]
    dev = client_params[names[0]].device

    # 1. weight divergence over every leaf, in the reference's leaf order
    with span("fl.divergence", dev):
        div = _divergence(client_params, global_params, names, n)

    # 2. K-means assignment on the feature layer
    with span("fl.kmeans", dev):
        labels = _labels(_features(client_params, n, feature_slice),
                         centroids)

    # 3.-4. the top-1 divergence of each cluster; eq. (4) over them
    with span("fl.select", dev):
        w = _round_weights(div, labels, sizes, num_clusters)
    with span("fl.fold", dev):
        new_global = {
            k: ops.flat_aggregate(client_params[k].reshape(n, -1), w,
                                  normalize=False)
            .reshape(global_params[k].shape).to(global_params[k].dtype)
            for k in names}
    return new_global, div, labels


def _divergence(clients: Params, glob: Params, names, n: int):
    """``[n]`` ‖w_n − w_g‖ over every leaf: each leaf's squared partial
    (``pairwise_l2``'s one-centroid kernel on the card), summed in leaf
    order."""
    sq = [ops.client_divergence_sq(clients[k].reshape(n, -1),
                                   glob[k].reshape(-1)) for k in names]
    return torch.sqrt(sum(sq))


def _features(clients: Params, n: int, feature_slice: int):
    """The K-means rows: ``lm_head`` (or the tied ``embed``), its first
    ``feature_slice`` columns where that is > 0."""
    feat = clients.get("lm_head", clients["embed"])
    feats = feat.reshape(n, -1)
    if feature_slice:
        feats = feats[:, :feature_slice].contiguous()    # [N, slice] rows
    return feats


def _labels(feats, centroids):
    return torch.argmin(ops.pairwise_sq_dists(feats, centroids), dim=1)


def _round_weights(div, labels, sizes, num_clusters: int):
    """Eq. (4)'s ``[N]`` weights: the top-1 divergence of each cluster
    selected (non-members at -1e30, the first on a tie, an empty cluster
    selecting nobody), D_n over their sum clamped at 1e-9."""
    onehot = torch.nn.functional.one_hot(labels, num_clusters).to(
        torch.float32)                                           # [N, c]
    masked = onehot * div[:, None] - (1.0 - onehot) * 1e30
    best = torch.argmax(masked, dim=0)                           # [c]
    has_member = torch.amax(onehot, dim=0) > 0.0
    sel = torch.zeros_like(div).index_add_(0, best,
                                           has_member.to(torch.float32))
    sel = torch.clamp(sel, max=1.0)
    w = sel * sizes.to(torch.float32)
    return w / torch.clamp(torch.sum(w), min=1e-9)


def fl_round_split(client_params: Params, global_params: Params,
                   centroids: torch.Tensor, sizes: torch.Tensor, *,
                   devices, num_clusters: int, feature_slice: int = 0
                   ) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """:func:`fl_round_step` with the stacked clients split over mesh
    positions: ``devices`` names each position's device (a device may
    appear more than once), position 0 the lead; the ``N`` clients must
    divide into one contiguous group a position. Each position gets its
    group by an explicit copy and computes the group's divergences and
    its partial eq.-(4) fold, leaf by leaf; the lead gathers the
    divergences and the feature rows, runs K-means and the selection as
    :func:`fl_round_step` does (so their bits are its bits), and sums the
    partial folds in position order. Returns what it returns, on the
    lead."""
    names = tree_order(client_params)
    n, d = client_params[names[0]].shape[0], len(devices)
    if n % d:
        raise ValueError(f"{n} clients do not split over {d} positions")
    per, lead = n // d, torch.device(devices[0])
    local = [{k: client_params[k][i * per:(i + 1) * per].to(dev)
              for k in names} for i, dev in enumerate(devices)]
    glob = [{k: global_params[k].to(dev) for k in names} for dev in devices]

    div = torch.cat([_divergence(loc, g, names, per).to(lead)
                     for loc, g in zip(local, glob)])
    feats = torch.cat([_features(loc, per, feature_slice).to(lead)
                       for loc in local])
    labels = _labels(feats, centroids.to(lead))
    w = _round_weights(div, labels, sizes.to(lead), num_clusters)

    partial = [{k: ops.flat_aggregate(loc[k].reshape(per, -1),
                                      w[i * per:(i + 1) * per].to(dev),
                                      normalize=False) for k in names}
               for i, (loc, dev) in enumerate(zip(local, devices))]
    new_global = {}
    for k in names:
        total = partial[0][k].to(lead)
        for part in partial[1:]:
            total = total + part[k].to(lead)
        new_global[k] = total.reshape(global_params[k].shape).to(
            global_params[k].dtype)
    return new_global, div, labels


def lower_fl_round(cfg: ModelConfig, mesh: Mesh, *, num_clients: int = 128,
                   num_clusters: int = 10, feature_slice: int = 0) -> Lowered:
    """The round for ``num_clients`` bf16 copies of the client
    architecture, laid out on ``mesh``: its arguments ``(clients,
    global, centroids, sizes)`` as ``meta`` structs with their shardings
    (the client axis over ``batch_axes``, then the leaf's own spec;
    centroids and sizes replicated), the results' shardings ``(global,
    divergence, labels)``. ``compile`` on a host mesh of several
    positions splits the clients over them."""
    p_struct = shp.param_structs(cfg, torch.bfloat16)
    p_shard = sh.params_shardings(p_struct, mesh)
    ba = sh.batch_axes(mesh, num_clients)
    c_struct = {k: shp.struct((num_clients,) + tuple(v.shape), v.dtype)
                for k, v in p_struct.items()}
    c_shard = {k: sh.NamedSharding(mesh, sh.P(ba if ba else None, *s.spec))
               for k, s in p_shard.items()}
    feat_dim = feature_slice or cfg.d_model * cfg.vocab_size
    cent = shp.struct((num_clusters, feat_dim), torch.float32)
    sizes = shp.struct((num_clients,), torch.float32)
    rep = sh.NamedSharding(mesh, sh.P())
    step = functools.partial(fl_round_step, num_clusters=num_clusters,
                             feature_slice=feature_slice)

    def split(host: Mesh):
        """The round on a host mesh of several positions: the clients
        over the positions of their batch axes (:func:`fl_round_split`),
        or whole on the lead where the client count does not divide them
        (the reference's spec then replicates the clients)."""
        if host.shape.get(sh.MODEL_AXIS, 1) > 1:
            raise NotImplementedError(
                f"the round on a host mesh of {host.shape}: the port has no "
                "SPMD partitioner; it splits the clients' axis only (a "
                "host mesh of model = 1)")
        if not ba:
            return step, 1
        devices = list(host.devices.flat)
        return functools.partial(fl_round_split, devices=devices,
                                 num_clusters=num_clusters,
                                 feature_slice=feature_slice), len(devices)

    return Lowered(step, (c_struct, p_struct, cent, sizes),
                   (c_shard, p_shard, rep, rep), (p_shard, rep, rep),
                   mesh=mesh, split=split)


def lower_fl_round_from_spec(spec, mesh: Mesh, *,
                             feature_slice: int = 0) -> Lowered:
    """Spec-API entry point: the round for an ``ExperimentSpec`` whose
    ``model`` names an architecture (``spec.clients`` LM clients,
    ``spec.num_clusters`` K-means clusters)."""
    from repro_torch.configs import get_config

    if spec.model == "auto":
        raise ValueError("spec.model must name an arch id (e.g. "
                         "'tinyllama-1.1b') for the sharded fl_round path")
    return lower_fl_round(get_config(spec.model), mesh,
                          num_clients=spec.clients,
                          num_clusters=spec.num_clusters,
                          feature_slice=feature_slice)
