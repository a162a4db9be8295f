"""RoundEngine — the compute of one FL round, split out of the host loop
(``repro_torch.core.fedavg.FLExperiment``), which owns all state.

Model weights travel on the FLAT PARAMETER PLANE: the global model is one
``[P]`` row and the clients' models are ``[S, P]`` rows (layout =
:func:`model_flat_spec`). Local SGD runs all ``S`` selected clients at
once on stacked ``[S, ...]`` parameters, where the reference ``vmap``s one
client's update; the eq.-(4) fold is the aggregator's, one
``ops.flat_aggregate`` row reduction (the hand-written CUDA kernel on the
card). For the LoRA LM the plane holds adapter rows and the frozen base
rides beside it (``base``).
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.profiler import record_function

from repro_torch.models.registry import model_def_for
from repro_torch.utils.trees import (StackFlattenSpec, flatten_stacked,
                                     stack_flatten_spec, unflatten_vector)


@functools.lru_cache(maxsize=64)
def model_flat_spec(model_cfg) -> StackFlattenSpec:
    """The flat-plane layout of one client model of ``model_cfg``, from
    shapes only (meta tensors: nothing is allocated)."""
    shapes = model_def_for(model_cfg).shapes(model_cfg)
    return stack_flatten_spec({name: torch.empty(shape, device="meta")
                               for name, shape in shapes.items()})


def make_local_update(model_cfg, lr: float, local_iters: int,
                      batch_size: int, base=None):
    """Local training of S clients at once: L SGD steps each on its own
    shard (Alg. 1 lines 6-10), all starting from the same global model.

    The returned ``local_update(params, images, labels, batch_idx)`` takes
    the global ``{name: tensor}``, the clients' shards ``images [S, D, ...]``
    (CNN images, or LM token windows) / ``labels [S, D]`` and the sample
    indices ``batch_idx [S, L, batch]`` (the experiment's draws), and
    returns ``{name: [S, ...]}``. Each step differentiates Σ_s (client s's
    mean loss): client s's parameters appear only in its own term, so its
    slice of the gradient is its own gradient. ``base`` is the workload's
    frozen weights, handed to its loss (``None`` for the paper CNN).
    """
    loss_fn = model_def_for(model_cfg).loss
    if base is not None:
        loss_fn = functools.partial(loss_fn, base=base)

    def local_update(params: Dict[str, torch.Tensor], images, labels,
                     batch_idx) -> Dict[str, torch.Tensor]:
        s = images.shape[0]
        if tuple(batch_idx.shape) != (s, local_iters, batch_size):
            raise ValueError(f"batch_idx is {tuple(batch_idx.shape)}; want "
                             f"[S, L, batch] = {(s, local_iters, batch_size)}")
        lanes = torch.arange(s, device=images.device)[:, None]
        stacked = {k: v.detach().expand((s,) + tuple(v.shape)).clone()
                   for k, v in params.items()}
        for step in range(local_iters):
            idx = batch_idx[:, step]                          # [S, batch]
            leaves = {k: v.requires_grad_(True) for k, v in stacked.items()}
            with torch.enable_grad():
                loss = loss_fn(leaves, images[lanes, idx],
                               labels[lanes, idx], model_cfg).sum()
                grads = torch.autograd.grad(loss, tuple(leaves.values()))
            with torch.no_grad():
                stacked = {k: w - lr * g
                           for (k, w), g in zip(leaves.items(), grads)}
        return stacked

    return local_update


class RoundEngine:
    """The round compute for one model and its SGD hyper-parameters; holds
    no state but the workload's frozen ``base`` weights (if any)."""

    def __init__(self, model_cfg, learning_rate: float, local_iters: int,
                 batch_size: int, base=None):
        self.flat_spec = model_flat_spec(model_cfg)
        self._local_update = make_local_update(model_cfg, learning_rate,
                                               local_iters, batch_size, base)
        frozen = {} if base is None else {"base": base}
        self._evaluate = functools.partial(model_def_for(model_cfg).evaluate,
                                           cfg=model_cfg, **frozen)

    def train_clients(self, global_vec, images, labels,
                      batch_idx) -> torch.Tensor:
        """Local training from the global row -> the clients' ``[S, P]``
        rows."""
        params = unflatten_vector(self.flat_spec, global_vec)
        stacked = self._local_update(params, images, labels, batch_idx)
        return flatten_stacked(self.flat_spec, stacked)

    def evaluate(self, global_vec, test_images, test_labels):
        """``(accuracy, per_class)`` tensors of the global row."""
        return self._evaluate(unflatten_vector(self.flat_spec, global_vec),
                              test_images, test_labels)

    def round_step(self, global_vec, images, labels, batch_idx, weights,
                   test_images, test_labels, aggregator):
        """Train the selected clients, fold them into the global row with
        ``aggregator.aggregate_flat`` (eq. 4), evaluate.
        Returns ``(rows [S, P], new global row [P], accuracy, per_class)``.
        Each phase is a profiler span (``fl.train`` …), which records
        nothing unless a profiler is on."""
        with record_function("fl.train"):
            rows = self.train_clients(global_vec, images, labels, batch_idx)
        with record_function("fl.aggregate"):
            new_global = aggregator.aggregate_flat(global_vec, rows, weights)
        with record_function("fl.evaluate"):
            acc, per_class = self.evaluate(new_global, test_images,
                                           test_labels)
        return rows, new_global, acc, per_class
