"""The experiment's one source of randomness.

Every random choice on the FL path comes from one draws object owned by
the experiment: the initial parameters, each round's local-SGD batch
indices, the k-means++ seeding choices, on the device-resident run of a
stochastic selector each round's selector draw, under a fading channel
(``repro_torch.api.scenario``) its CN(0,1) draws, and under the
buffered-asynchronous engine's churn each tick's leave and join uniforms,
under faults (``repro_torch.core.faults``) each dispatch's drop and
corrupt masks — nothing else on this path draws — plus, for a workload
with frozen weights (the LoRA LM), that base, and the byzantine subset of
a fault spec, each from a stream of its own. :class:`TorchDraws` is the
default, a ``torch.Generator`` on the experiment's device seeded from
``spec.seed``. ``jax.random`` and torch
give different numbers for one seed, so a parity test hands the experiment
an object with the same methods that replays the reference's draws.

The order of the draws is part of the contract (the reference splits its
key in the same order): the initial parameters; at the start of a
device-resident run under a fading channel, the fade's h_0
(``channel_init``); the initial round's batch indices, then its k-means++
choices, then (fading) the initial round's fade step (``channel_step``);
then per round the fade step (fading), the selector's draw (where the
selector takes one), the round's batch indices and, under an active
fault spec, the round's fault masks (the reference splits its fault key
after training). The device-resident run makes every round's draws
before its first round.

A tick of the buffered-asynchronous engine (``repro_torch.core.
async_engine``) draws in the same order with churn first: the churn step
(``churn_step``: the leave uniforms, then the join uniforms), the fade
step, the selector's draw, under faults the dispatch's fault masks, then
the batch indices — the reference's key splits (the churn split, then
``select_phase``'s fade and selector splits, ``_async_fault_plan``'s at
dispatch, then training's); the paged tick's pieces draw in the same
order. A stochastic selector always takes its draw here.

``state()`` and ``load_state()`` save and restore the generator, so a run
resumed from a checkpoint draws what the uninterrupted run would have.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.registry import model_def_for

_SQRT_HALF = math.sqrt(0.5)


class TorchDraws:
    """Draws from ``torch.Generator(device)`` seeded with ``seed``; every
    result is a tensor on ``device`` (no host round trip)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def init_params(self, model_cfg):
        """One model's initial ``{name: tensor}``."""
        return model_def_for(model_cfg).init(model_cfg, self.generator,
                                             self.device)

    def base_params(self, model_cfg):
        """The frozen weights of a workload that has them (the LoRA LM):
        the model's own draw from its config's ``base_seed`` on a generator
        of its own, not from this stream, cached per (config, device)."""
        return model_def_for(model_cfg).base(model_cfg, self.device)

    def batch_indices(self, n: int, local_iters: int, batch_size: int,
                      num_samples: int) -> torch.Tensor:
        """``[n, L, batch]`` sample indices into each client's shard."""
        return torch.randint(0, num_samples, (n, local_iters, batch_size),
                             generator=self.generator, device=self.device)

    def selector_draw(self, kind: str, n: int) -> torch.Tensor:
        """One round's draw of a stochastic selector over ``n`` devices
        (``TracedSelector.draw_kind``): ``"uniform"``, ``[n]`` uniforms in
        [0, 1); ``"permutation"``, a permutation of ``range(n)`` (int64),
        the order of ``n`` uniforms (the stable sort keeps it one even on
        a tie). Made on the device: nothing waits for the card."""
        u = torch.rand((n,), generator=self.generator, device=self.device)
        if kind == "uniform":
            return u
        if kind == "permutation":
            return torch.argsort(u, stable=True)
        raise ValueError(f"unknown selector draw {kind!r}; the port draws "
                         "'uniform' or 'permutation'")

    def churn_step(self, n: int):
        """One tick's churn draw over ``n`` clients: ``(leave, join)``,
        ``[n]`` uniforms in [0, 1) each (a client leaves where its leave
        uniform is below p_leave, rejoins where its join uniform is below
        p_join)."""
        leave = torch.rand((n,), generator=self.generator, device=self.device)
        join = torch.rand((n,), generator=self.generator, device=self.device)
        return leave, join

    def fault_masks(self, spec, shape) -> torch.Tensor:
        """One dispatch's faults over ``shape`` lanes: ``[2, *shape]``
        bool, the drop mask (uniform < ``spec.outage``) then the corrupt
        mask (uniform < ``spec.corrupt``). Both uniforms are drawn at any
        rates, so the stream's position never depends on them."""
        u = torch.rand((2,) + tuple(shape), generator=self.generator,
                       device=self.device)
        return torch.stack([u[0] < spec.outage, u[1] < spec.corrupt])

    @staticmethod
    def byzantine(spec, n: int) -> torch.Tensor:
        """The fixed adversarial subset of ``n`` clients, ``[n]`` bool on
        the CPU: uniforms below ``spec.byzantine`` from a CPU generator
        seeded with ``spec.seed`` — its own stream (as the reference draws
        from ``PRNGKey(spec.seed)``), the same subset on every device."""
        g = torch.Generator(device="cpu")
        g.manual_seed(int(spec.seed))
        return torch.rand((n,), generator=g) < spec.byzantine

    def state(self) -> dict:
        """The generator's state, ``{"generator": uint8 tensor}``."""
        return {"generator": self.generator.get_state()}

    def load_state(self, state: dict) -> None:
        """Restore a :meth:`state`."""
        self.generator.set_state(torch.as_tensor(state["generator"],
                                                 dtype=torch.uint8).cpu())

    def _complex_normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape) + (2,), generator=self.generator,
                           device=self.device) * _SQRT_HALF

    def channel_init(self, shape) -> torch.Tensor:
        """A fading channel's h_0 ~ CN(0,1) over ``shape`` (one value a
        device): ``shape + (2,)`` real fp32 (re, im), each N(0, ½)."""
        return self._complex_normal(shape)

    def channel_step(self, shape) -> torch.Tensor:
        """One round's fade innovation w ~ CN(0,1), as :meth:`channel_init`."""
        return self._complex_normal(shape)

    def kmeans_seed(self, n: int, c: int) -> torch.Tensor:
        """The first k-means++ centroid of a fit over ``n`` rows into ``c``
        clusters (a 0-d index)."""
        return torch.randint(0, n, (), generator=self.generator,
                             device=self.device)

    def kmeans_choice(self, i: int, p: torch.Tensor) -> torch.Tensor:
        """Centroid ``i`` drawn with probabilities ``p`` (uniform when
        every row already sits on a centroid), by inverting the CDF at one
        uniform: unlike ``torch.multinomial``, which checks ``p`` on the
        host, nothing here waits for the card."""
        p = torch.where(p.sum() > 0, p, torch.ones_like(p))
        cdf = torch.cumsum(p, 0)
        u = torch.rand((1,), generator=self.generator, device=p.device,
                       dtype=cdf.dtype) * cdf[-1]
        # the first row whose CDF passes u: a row of p = 0 never does
        pick = torch.searchsorted(cdf, u, right=True)
        return torch.clamp(pick, max=p.shape[0] - 1)[0]
