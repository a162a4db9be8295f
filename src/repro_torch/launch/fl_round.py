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
one-device host mesh, compiles to :func:`fl_round_step` itself.
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

    # 1. weight divergence over every leaf, in the reference's leaf order
    sq = [ops.client_divergence_sq(client_params[k].reshape(n, -1),
                                   global_params[k].reshape(-1))
          for k in names]
    div = torch.sqrt(sum(sq))

    # 2. K-means assignment on the feature layer
    feat = client_params.get("lm_head", client_params["embed"])
    feats = feat.reshape(n, -1)
    if feature_slice:
        feats = feats[:, :feature_slice].contiguous()    # [N, slice] rows
    labels = torch.argmin(ops.pairwise_sq_dists(feats, centroids), dim=1)

    # 3. the top-1 divergence of each cluster
    onehot = torch.nn.functional.one_hot(labels, num_clusters).to(
        torch.float32)                                           # [N, c]
    masked = onehot * div[:, None] - (1.0 - onehot) * 1e30
    best = torch.argmax(masked, dim=0)                           # [c]
    has_member = torch.amax(onehot, dim=0) > 0.0
    sel = torch.zeros_like(div).index_add_(0, best,
                                           has_member.to(torch.float32))
    sel = torch.clamp(sel, max=1.0)

    # 4. eq. (4) over the selected set
    w = sel * sizes.to(torch.float32)
    w = w / torch.clamp(torch.sum(w), min=1e-9)
    new_global = {
        k: ops.flat_aggregate(client_params[k].reshape(n, -1), w,
                              normalize=False)
        .reshape(global_params[k].shape).to(global_params[k].dtype)
        for k in names}
    return new_global, div, labels


def lower_fl_round(cfg: ModelConfig, mesh: Mesh, *, num_clients: int = 128,
                   num_clusters: int = 10, feature_slice: int = 0) -> Lowered:
    """The round for ``num_clients`` bf16 copies of the client
    architecture, laid out on ``mesh``: its arguments ``(clients,
    global, centroids, sizes)`` as ``meta`` structs with their shardings
    (the client axis over ``batch_axes``, then the leaf's own spec;
    centroids and sizes replicated), the results' shardings ``(global,
    divergence, labels)``."""
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
    return Lowered(step, (c_struct, p_struct, cent, sizes),
                   (c_shard, p_shard, rep, rep), (p_shard, rep, rep),
                   mesh=mesh)


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
