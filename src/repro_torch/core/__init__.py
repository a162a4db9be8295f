"""The paper's primary contribution: SAO spectrum allocation (Alg. 5/6),
K-means device clustering (Alg. 2-3), weight-divergence selection (Alg. 4),
the FedAvg loop (Alg. 1), the wireless system model (eqs. 5-11), and the
compared baselines.

The reference's names (``repro.core``), less one left out on purpose:
``RoundEngine``, whose jitted round step ``build_round_phases`` and
``FLExperiment.phases`` replace (callers of ``exp.engine.train_clients``
use ``FLExperiment.train_clients``). ``RoundResult`` is the host loop's
result of one round, as in the reference.
"""
# the strategies the round loop resolves import core modules: the api
# (and with it the strategies) loads first, whichever package is imported
import repro_torch.api  # noqa: F401
from repro_torch.core.wireless import (Fleet, effective_arrays, fleet_arrays,
                                       rate_mbps, round_totals, sample_fleet)
from repro_torch.core.sao import SAOSolution, kkt_residuals, solve_sao
from repro_torch.core.baselines import (AllocResult, equal_bandwidth,
                                        fedl_lambda, tune_fedl_lambda)
from repro_torch.core.power import optimal_transmit_power
from repro_torch.core.clustering import (adjusted_rand_index,
                                         clusters_from_labels,
                                         extract_features,
                                         extract_features_flat, kmeans_fit,
                                         kmeans_predict)
from repro_torch.core.divergence import (pairwise_divergence_matrix,
                                         weight_divergence,
                                         weight_divergence_flat)
from repro_torch.core import selection
from repro_torch.core.engine import (EngineConfig, TracedRunResult,
                                     make_local_update, model_flat_spec,
                                     run_rounds)
from repro_torch.core.fedavg import FLExperiment, FLHistory, RoundResult
from repro_torch.core.cohort import CohortHistory, CohortRunner

__all__ = [
    "Fleet", "effective_arrays", "sample_fleet", "fleet_arrays",
    "round_totals", "rate_mbps", "solve_sao", "kkt_residuals", "SAOSolution",
    "equal_bandwidth", "fedl_lambda", "tune_fedl_lambda", "AllocResult",
    "optimal_transmit_power", "kmeans_fit", "kmeans_predict",
    "extract_features", "extract_features_flat", "clusters_from_labels",
    "adjusted_rand_index", "weight_divergence", "weight_divergence_flat",
    "pairwise_divergence_matrix", "selection", "EngineConfig", "RoundResult",
    "TracedRunResult", "model_flat_spec", "run_rounds", "FLExperiment",
    "FLHistory", "make_local_update", "CohortHistory", "CohortRunner",
]
