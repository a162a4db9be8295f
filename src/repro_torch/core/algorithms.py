"""Beyond-paper FL objective variants on the same substrate
(``repro.core.algorithms``).

  FedProx (Li et al. 2020): the proximal term μ/2‖w − w_global‖² in each
          client's objective — stabilizes non-iid local updates.
  FedAvgM (Hsu et al. 2019): server momentum over the pseudo-gradient
          Δ_k = w_k − aggregate(w_locals).

They compose with the paper's selection and SAO layers unchanged
(selection sees the same weight-divergence signal, SAO the same payloads).
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import make_local_update


def make_fedprox_local_update(model_cfg, lr: float, local_iters: int,
                              batch_size: int, mu: float = 0.01, base=None):
    """FedProx client update: L SGD steps of S clients at once on
    f_n(w) + μ/2‖w − w_g‖², in the stacked form of
    ``repro_torch.core.engine.make_local_update`` (the reference
    ``vmap``s one client's). The squared distance is taken over every
    leaf in fp32."""

    def proximal(stacked, params):
        sq = sum(torch.sum(torch.square(
                     (w.to(torch.float32) - params[k].to(torch.float32))
                     .reshape(w.shape[0], -1)), dim=1)
                 for k, w in stacked.items())
        return 0.5 * mu * sq

    return make_local_update(model_cfg, lr, local_iters, batch_size, base,
                             penalty=proximal)


class ServerMomentum:
    """FedAvgM: w ← w − η·v,  v ← β·v + (w − w_agg), over ``{name:
    tensor}`` models; ``v`` is ``None`` until the first step, which sets
    it to the pseudo-gradient."""

    def __init__(self, beta: float = 0.9, lr: float = 1.0):
        self.beta = beta
        self.lr = lr
        self.v = None

    def step(self, global_params, aggregated):
        delta = {k: global_params[k] - aggregated[k] for k in global_params}
        if self.v is None:
            self.v = delta
        else:
            self.v = {k: self.v[k] * self.beta + delta[k] for k in delta}
        return {k: global_params[k] - self.v[k] * self.lr
                for k in global_params}
