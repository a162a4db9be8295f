"""The one generator the traffic files (``traffic/<name>.json``) feed: every
input of a run made from ``--seed`` by the benchmark itself, on the
device, and handed to the program and to the reference alike.

- :class:`SeedDraws` is the draws object an FL experiment takes (the
  methods of ``repro_torch.core.draws.TorchDraws`` that the paper's path
  calls): the initial model, each round's local-SGD batch indices and the
  k-means++ choices, from a ``torch.Generator`` seeded with the seed. It
  keeps every model and batch it hands out, in order, for the reference.
- :func:`lm_clients` makes the round over whole LM clients: a global
  model from the seed, ``clients`` copies of it with Gaussian noise of a
  scale that grows with the client's index, the K-means centroids (every
  ``centroid_stride``-th client's feature block in fp32) and the data
  sizes.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.cost import cnn as cnn_cost
from portbench.cost import lm as lm_cost


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class SeedDraws:
    """The experiment's draws from the benchmark's seed. ``models`` holds
    the initial model it gave (``{name: tensor}``), ``batches`` every
    ``[n, L, batch]`` index tensor in the order given."""

    def __init__(self, seed: int, device, model: dict):
        self.device = torch.device(device)
        self.generator = _generator(seed, self.device)
        self.shapes = cnn_cost.shapes(model)
        self.models: List[Dict[str, torch.Tensor]] = []
        self.batches: List[torch.Tensor] = []

    def init_params(self, model_cfg=None) -> Dict[str, torch.Tensor]:
        """One model: weights N(0, 1/fan_in), biases 0 (the paper's CNN
        in the port's layout)."""
        out = {}
        for name, shape in self.shapes.items():
            if name.startswith("b_"):
                out[name] = torch.zeros(shape, device=self.device)
            else:
                out[name] = torch.randn(
                    shape, generator=self.generator, device=self.device
                ).mul_(1.0 / math.sqrt(math.prod(shape[:-1])))
        self.models.append({k: v.clone() for k, v in out.items()})
        return out

    def batch_indices(self, n: int, local_iters: int, batch_size: int,
                      num_samples: int) -> torch.Tensor:
        out = torch.randint(0, num_samples, (n, local_iters, batch_size),
                            generator=self.generator, device=self.device)
        self.batches.append(out)
        return out

    def kmeans_seed(self, n: int, c: int) -> torch.Tensor:
        return torch.randint(0, n, (), generator=self.generator,
                             device=self.device)

    def kmeans_choice(self, i: int, p: torch.Tensor) -> torch.Tensor:
        """A row drawn with probabilities ``p`` (uniform where all are 0)
        by one uniform against the CDF, on the device."""
        p = torch.where(p.sum() > 0, p, torch.ones_like(p))
        cdf = torch.cumsum(p, 0)
        u = torch.rand((1,), generator=self.generator, device=p.device,
                       dtype=cdf.dtype) * cdf[-1]
        pick = torch.searchsorted(cdf, u, right=True)
        return torch.clamp(pick, max=p.shape[0] - 1)[0]


def sizes(spec: str, n: int, device) -> torch.Tensor:
    """``"a..b"``: the data sizes a, a+1, ... of the ``n`` clients."""
    lo, _, _ = spec.partition("..")
    return torch.arange(float(lo), float(lo) + n, device=device)


def lm_global(cfg: dict, seed: int, device,
              dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """A model of the configuration's leaves from the seed: the embedding
    N(0, 0.02²), matrices N(0, 1/fan_in), biases N(0, 0.02²), norms 1; one
    draw a leaf on the device, cast to ``dtype``."""
    gen = _generator(seed, device)
    out = {}
    for name, shape in lm_cost.leaves(cfg).items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("final_norm", "ln1", "ln2"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        std = (1.0 / math.sqrt(shape[-2]) if len(shape) >= 2
               and name != "embed" else 0.02)
        out[name] = torch.randn(shape, generator=gen, device=device).mul_(
            std).to(dtype)
    return out


def lm_clients(cfg: dict, traffic: dict, seed: int, device):
    """``(global, clients, centroids, sizes)``: the global model, the
    ``[N, ...]`` stacked clients (client i the global model plus noise of
    scale ``noise·(1 + growth·i/N)``, drawn a client's leaf at a time),
    the ``[c, F]`` fp32 centroids (every ``centroid_stride``-th client's
    feature block) and the ``[N]`` data sizes."""
    n = traffic["clients"]
    g = lm_global(cfg, seed, device)
    gen = _generator(seed + 1, device)
    clients = {}
    for k, v in g.items():
        clients[k] = torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                                 device=device)
        for i in range(n):
            scale = traffic["noise"] * (1.0 + traffic["noise_growth"] * i / n)
            noise = torch.randn(v.shape, generator=gen, device=device)
            clients[k][i] = noise.mul_(scale).add_(v.float())
            del noise
    feat = clients[lm_cost.feature_leaf(cfg)].reshape(n, -1)
    cent = feat[::traffic["centroid_stride"]][:traffic["clusters"]].float()
    return g, clients, cent, sizes(traffic["sizes"], n, device)
