"""The port's public entry points:
``build_experiment(ExperimentSpec(), device=None).run()`` and
``build_cohort(ExperimentSpec(cohort=8), device=None).run()``, and the
strategy registries they resolve through."""
from repro_torch.api.registry import (AGGREGATORS, ALLOCATORS, SELECTORS,
                                      Registry, Strategy, StrategyError,
                                      get_registry)
from repro_torch.api.protocols import Allocation, SelectionContext
from repro_torch.api.spec import SPEC_VERSION, ExperimentSpec
from repro_torch.api.build import build_cohort, build_experiment

__all__ = ["AGGREGATORS", "ALLOCATORS", "SELECTORS", "Registry", "Strategy",
           "StrategyError", "get_registry", "Allocation", "SelectionContext",
           "SPEC_VERSION", "ExperimentSpec", "build_cohort",
           "build_experiment"]
