"""The port's public experiment-construction API (``repro.api``'s names).

    from repro_torch.api import (ExperimentSpec, build_experiment,
                                 SELECTORS, ALLOCATORS, AGGREGATORS,
                                 COMPRESSORS)

Strategies resolve through per-stage registries (``repro_torch.strategies``
holds the built-ins); experiments are declared as a frozen,
JSON-serializable ``ExperimentSpec`` and materialized on a device by
``build_experiment(spec, device=None)`` (``cuda`` unless the caller names
another) or, as lanes of one captured round, by ``build_cohort``.
"""
from repro_torch.api.registry import (AGGREGATORS, ALLOCATORS, CHANNELS,
                                      COMPRESSORS, SELECTORS, Registry,
                                      Strategy, StrategyError, get_registry,
                                      register_channel)
from repro_torch.api.protocols import (Aggregator, Allocation, Allocator,
                                       ChannelModel, Compressor, RoundState,
                                       SelectionContext, Selector,
                                       TracedAllocator, TracedContext,
                                       TracedSelector)
from repro_torch.api.scenario import (CellSpec, FleetSpec, build_fleet,
                                      multicell_fleet_spec)
from repro_torch.api.spec import SPEC_VERSION, ExperimentSpec
from repro_torch.api.build import (build_cohort, build_experiment,
                                   fl_config_from_spec, fleet_for_cell)
import repro_torch.strategies  # noqa: F401,E402  (register the built-ins)

__all__ = [
    "AGGREGATORS", "ALLOCATORS", "CHANNELS", "COMPRESSORS", "SELECTORS",
    "Registry", "Strategy", "StrategyError", "get_registry",
    "register_channel",
    "Allocation", "Aggregator", "Allocator", "ChannelModel",
    "Compressor", "RoundState", "SelectionContext", "Selector",
    "TracedAllocator", "TracedContext", "TracedSelector",
    "CellSpec", "FleetSpec", "build_fleet", "multicell_fleet_spec",
    "SPEC_VERSION", "ExperimentSpec",
    "build_cohort", "build_experiment", "fl_config_from_spec",
    "fleet_for_cell",
]
