"""``build_experiment(spec)`` — from a declarative ``ExperimentSpec`` to a
runnable ``FLExperiment`` on one device (one cell of a multi-cell fleet:
``cell=``); ``build_cohort(spec)`` — its seeds ``seed .. seed + cohort −
1`` (× the fleet's cells) as lanes of one device-resident program
(``repro_torch.core.cohort.CohortRunner``)."""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.api.registry import (AGGREGATORS, ALLOCATORS, CHANNELS,
                                      COMPRESSORS, SELECTORS)
from repro_torch.api.scenario import CELL_SEED_STRIDE, build_fleet
from repro_torch.api.spec import ExperimentSpec
from repro_torch.configs.base import FLConfig
from repro_torch.configs.paper_cnn import CNN_CONFIGS
from repro_torch.core.wireless import sample_fleet
from repro_torch.data.partition import partition_bias, partition_bias_lazy
from repro_torch.data.synthetic import make_dataset
from repro_torch.models.registry import model_def_for, workload_config

#: clients at and above which a paged build keeps the partition lazy
#: (index-backed); below it a paged experiment takes the image stack too
LAZY_PARTITION_MIN = 50_000


def fl_config_from_spec(spec: ExperimentSpec,
                        num_devices: Optional[int] = None) -> FLConfig:
    return FLConfig(num_devices=num_devices or spec.clients,
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


# a multi-cell cohort asks for every cell of one build (seed × C lanes):
# the whole-fleet build is cached, so its O(C²·N) geometry runs once a
# seed. Fleets are never changed in place (select, with_power and replace
# copy), so experiments may share one.
_FLEET_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_FLEET_CACHE_MAX = 16


def _built_fleet(fs, seed: int, clients: Optional[int],
                 bandwidth_mhz: float):
    key = (fs.to_json(), seed, clients, bandwidth_mhz)
    fleet = _FLEET_CACHE.get(key)
    if fleet is None:
        fleet = _FLEET_CACHE[key] = build_fleet(
            fs, seed, clients=clients, bandwidth_mhz=bandwidth_mhz)
        while len(_FLEET_CACHE) > _FLEET_CACHE_MAX:
            _FLEET_CACHE.popitem(last=False)
    else:
        _FLEET_CACHE.move_to_end(key)
    return fleet


def fleet_for_cell(spec: ExperimentSpec, cell: int = 0):
    """``(fleet, channel)``: the (sub-)fleet cell ``cell`` serves and the
    resolved channel model. ``spec.fleet is None`` draws ``sample_fleet``
    (the same draws as ``FleetSpec()``)."""
    if spec.fleet is None:
        if cell:
            raise ValueError("cell > 0 needs a multi-cell FleetSpec "
                             "(ExperimentSpec.fleet)")
        return (sample_fleet(spec.clients, seed=spec.resolved_fleet_seed),
                CHANNELS.resolve("static"))
    fs = spec.fleet
    if not 0 <= cell < fs.num_cells:
        raise ValueError(f"cell {cell} out of range for a "
                         f"{fs.num_cells}-cell FleetSpec")
    full = _built_fleet(fs, spec.resolved_fleet_seed, spec.clients,
                        spec.bandwidth_mhz)
    fleet = full.cell_fleet(cell) if fs.num_cells > 1 else full
    return fleet, CHANNELS.resolve(fs.channel)


def build_experiment(spec: ExperimentSpec, device=None, *, cell: int = 0,
                     test_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                     draws=None) -> "FLExperiment":
    """Materialize dataset, partition, fleet and experiment from ``spec`` on
    ``device`` (default ``cuda``). ``cell`` picks one cell of a multi-cell
    ``FleetSpec``: each cell is its own FL system sharing the band with
    the others, its partition drawn from its own stream (seed
    ``resolved_partition_seed + CELL_SEED_STRIDE·cell``). ``test_data``
    (``(images, labels)``) replaces the held-out evaluation set. ``draws``
    replaces the experiment's default ``torch.Generator`` draws
    (``repro_torch.core.draws``). A workload that builds its own data (the
    LoRA LMs) ignores ``spec.dataset``. A paged fleet of at least
    ``LAZY_PARTITION_MIN`` clients partitions lazily (per-client sample
    indices into the pool, not an ``[N, D, H, W, C]`` image stack)."""
    from repro_torch.core.fedavg import FLExperiment   # imports the api

    dev = resolve_device(device)
    model_cfg = (CNN_CONFIGS[spec.dataset] if spec.model in ("auto", "cnn")
                 else workload_config(spec.model))
    mdef = model_def_for(model_cfg)
    fleet, channel = fleet_for_cell(spec, cell)
    n = fleet.num_devices

    def data(samples, seed):
        if mdef.make_dataset is not None:
            return mdef.make_dataset(model_cfg, samples, seed=seed)
        return make_dataset(spec.dataset, samples, seed=seed)

    ds = data(spec.train_samples, spec.resolved_data_seed)
    if test_data is None:
        test = data(spec.test_samples, spec.resolved_test_seed)
        test_images, test_labels = test.images, test.labels
    else:
        test_images, test_labels = test_data
    partition = (partition_bias_lazy
                 if spec.store == "paged" and n >= LAZY_PARTITION_MIN
                 else partition_bias)
    fed = partition(ds, n, spec.samples_per_client, spec.sigma,
                    seed=spec.resolved_partition_seed
                    + CELL_SEED_STRIDE * cell)
    exp = FLExperiment(
        model_cfg, fed, test_images, test_labels, fleet,
        fl_config_from_spec(spec, num_devices=n), device=dev,
        bandwidth_mhz=spec.bandwidth_mhz, seed=spec.seed,
        batch_size=spec.batch_size,
        selection=SELECTORS.resolve(spec.selection),
        allocator=ALLOCATORS.resolve(spec.allocator),
        aggregator=AGGREGATORS.resolve(spec.aggregator),
        compression=COMPRESSORS.resolve(spec.compressor),
        channel=channel, fedprox_mu=spec.fedprox_mu, draws=draws,
        churn=(spec.churn_leave, spec.churn_join), store=spec.store,
        k_max=spec.k_max, chunk_size=spec.chunk_size,
        div_refresh_every=spec.div_refresh_every, cluster=spec.cluster,
        faults=spec.faults, quarantine_after=spec.quarantine_after,
        p_shards=spec.p_shards)
    exp.spec = spec
    exp.cell = cell
    return exp


def build_cohort(spec: ExperimentSpec, device=None, *, draws=None):
    """A ``CohortRunner`` for ``spec`` on ``device`` (default ``cuda``;
    a machine with no card raises unless the caller passes
    ``device="cpu"``): seeds ``seed .. seed + cohort − 1``, each with the
    fleet's cells, run as lanes of one captured round (lane ``seed_index ·
    cells + cell``; ``repro_torch.core.cohort``), split over the cards
    this host sees (``cohort_mesh``: one captured round a card, each over
    its share of the lanes). ``draws``: ``seed -> draws object`` in place
    of each lane's default draws.

    Every strategy must be traceable, and a stochastic selector must name
    its draw (``draw_kind``): a selector the cohort lacks raises here,
    naming the port. Faults and quarantine are refused, as in the
    reference."""
    from repro_torch.core.cohort import CohortRunner     # imports the api
    from repro_torch.core.engine import selector_draw_kind

    if ((spec.faults is not None and spec.faults.active)
            or spec.quarantine_after > 0):
        raise ValueError(
            "fault injection / quarantine is not wired into the vmapped "
            "cohort program yet — run the spec through build_experiment "
            "(single-lane) instead, or drop the faults/quarantine_after "
            "fields")
    selector_draw_kind(SELECTORS.resolve(spec.selection))
    return CohortRunner(spec, device, draws=draws)
