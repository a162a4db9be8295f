"""The port's public entry point:
``build_experiment(ExperimentSpec(), device=None).run()``, and the
strategy registries it resolves through."""
from repro_torch.api.registry import (AGGREGATORS, ALLOCATORS, SELECTORS,
                                      Registry, Strategy, StrategyError,
                                      get_registry)
from repro_torch.api.protocols import Allocation, SelectionContext
from repro_torch.api.spec import SPEC_VERSION, ExperimentSpec
from repro_torch.api.build import build_experiment

__all__ = ["AGGREGATORS", "ALLOCATORS", "SELECTORS", "Registry", "Strategy",
           "StrategyError", "get_registry", "Allocation", "SelectionContext",
           "SPEC_VERSION", "ExperimentSpec", "build_experiment"]
