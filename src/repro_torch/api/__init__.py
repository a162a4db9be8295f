"""The port's public entry point:
``build_experiment(ExperimentSpec(), device=None).run()``."""
from repro_torch.api.build import build_experiment
from repro_torch.api.spec import ExperimentSpec

__all__ = ["ExperimentSpec", "build_experiment"]
