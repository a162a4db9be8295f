"""``build_experiment(spec)`` — from a declarative ``ExperimentSpec`` to a
runnable ``FLExperiment`` on one device; ``build_cohort(spec)`` — its
seeds ``seed .. seed + cohort − 1`` as lanes of one device-resident
program (``repro_torch.core.cohort.CohortRunner``)."""
from __future__ import annotations

import torch

from repro_torch.api.registry import AGGREGATORS, ALLOCATORS, SELECTORS
from repro_torch.api.spec import ExperimentSpec
from repro_torch.configs.base import FLConfig
from repro_torch.configs.paper_cnn import CNN_CONFIGS
from repro_torch.core.wireless import sample_fleet
from repro_torch.data.partition import partition_bias
from repro_torch.data.synthetic import make_dataset
from repro_torch.models.registry import model_def_for, workload_config


def fl_config_from_spec(spec: ExperimentSpec) -> FLConfig:
    return FLConfig(num_devices=spec.clients,
                    devices_per_round=spec.devices_per_round,
                    local_iters=spec.local_iters,
                    num_clusters=spec.num_clusters,
                    selected_per_cluster=spec.selected_per_cluster,
                    learning_rate=spec.learning_rate,
                    sigma=spec.sigma,
                    target_accuracy=spec.target_accuracy,
                    max_rounds=spec.rounds,
                    selection=spec.selection["name"],
                    feature_layer=spec.feature_layer)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; a CUDA device
    with no card raises — the port never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' to run its plain PyTorch paths")
    return dev


def build_experiment(spec: ExperimentSpec, device=None, *,
                     draws=None) -> "FLExperiment":
    """Materialize dataset, partition, fleet and experiment from ``spec`` on
    ``device`` (default ``cuda``). ``draws`` replaces the experiment's default
    ``torch.Generator`` draws (``repro_torch.core.draws``). A workload that
    builds its own data (the LoRA LMs) ignores ``spec.dataset``."""
    from repro_torch.core.fedavg import FLExperiment   # imports the api

    dev = resolve_device(device)
    model_cfg = (CNN_CONFIGS[spec.dataset] if spec.model in ("auto", "cnn")
                 else workload_config(spec.model))
    mdef = model_def_for(model_cfg)
    fleet = sample_fleet(spec.clients, seed=spec.resolved_fleet_seed)
    if mdef.make_dataset is not None:
        ds = mdef.make_dataset(model_cfg, spec.train_samples,
                               seed=spec.resolved_data_seed)
        test = mdef.make_dataset(model_cfg, spec.test_samples,
                                 seed=spec.resolved_test_seed)
    else:
        ds = make_dataset(spec.dataset, spec.train_samples,
                          seed=spec.resolved_data_seed)
        test = make_dataset(spec.dataset, spec.test_samples,
                            seed=spec.resolved_test_seed)
    fed = partition_bias(ds, spec.clients, spec.samples_per_client,
                         spec.sigma, seed=spec.resolved_partition_seed)
    exp = FLExperiment(
        model_cfg, fed, test.images, test.labels, fleet,
        fl_config_from_spec(spec), device=dev,
        bandwidth_mhz=spec.bandwidth_mhz, seed=spec.seed,
        batch_size=spec.batch_size,
        selection=SELECTORS.resolve(spec.selection),
        allocator=ALLOCATORS.resolve(spec.allocator),
        aggregator=AGGREGATORS.resolve(spec.aggregator),
        fedprox_mu=spec.fedprox_mu, draws=draws)
    exp.spec = spec
    return exp


def build_cohort(spec: ExperimentSpec, device=None, *, draws=None):
    """A ``CohortRunner`` for ``spec`` on ``device`` (default ``cuda``;
    a machine with no card raises unless the caller passes
    ``device="cpu"``): seeds ``seed .. seed + cohort − 1`` run as lanes of
    one captured round (``repro_torch.core.cohort``). ``draws``: ``seed ->
    draws object`` in place of each lane's default draws.

    Every strategy must be traceable, and a stochastic selector must name
    its draw (``draw_kind``): a selector the cohort lacks raises here,
    naming the port."""
    from repro_torch.core.cohort import CohortRunner     # imports the api
    from repro_torch.core.engine import selector_draw_kind

    selector_draw_kind(SELECTORS.resolve(spec.selection))
    return CohortRunner(spec, device, draws=draws)
