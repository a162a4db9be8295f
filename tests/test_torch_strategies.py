"""The port's strategy layer against the reference's: every selector's
``select(ctx)`` from two Generators seeded alike (the same indices, bit
for bit), ``kmeans_predict``, and the registry and ``ExperimentSpec``
cases of ``tests/test_api.py`` on the port's registries."""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ALLOCATORS as REF_ALLOCATORS
from repro.api import SELECTORS as REF_SELECTORS
from repro.api.protocols import SelectionContext as RefContext
from repro.core import clustering as ref_clustering
from repro.core.wireless import sample_fleet as ref_sample_fleet

from repro_torch.api import (AGGREGATORS, ALLOCATORS, SELECTORS,
                             Allocation, ExperimentSpec, Registry,
                             SelectionContext, StrategyError,
                             build_experiment)
from repro_torch.core.clustering import kmeans_predict
from repro_torch.core.wireless import sample_fleet

TINY = dict(dataset="fashion", clients=8, samples_per_client=16,
            train_samples=160, test_samples=80, local_iters=2, batch_size=8,
            rounds=1, devices_per_round=4, num_clusters=4,
            learning_rate=0.05)

SELECTOR_CASES = ["random", "kmeans_random", "divergence", "icas",
                  "icas:0.3", "rra", "rra:5", "stochastic-sched",
                  {"name": "icas", "params": {"beta": 0.3}},
                  {"name": "rra", "params": {"target_mean": 5}}]


def _contexts(seed, n=40, c=10, S=10, s=1):
    """A reference and a port context over the same fleet, clusters and
    divergences, each with its own Generator seeded alike."""
    rng = np.random.default_rng(100 + seed)
    labels = rng.integers(0, c, n)
    labels[:c] = np.arange(c)                # no cluster empty
    div = rng.gamma(2.0, 1.0, n).astype(np.float32)
    div[[3, 7]] = div[5]                      # ties
    clusters = [np.flatnonzero(labels == i) for i in range(c)]
    common = dict(num_devices=n, devices_per_round=S, selected_per_cluster=s,
                  bandwidth_mhz=20.0, clusters=clusters,
                  divergences=lambda: div.copy())
    ref = RefContext(rng=np.random.default_rng(seed),
                     fleet=ref_sample_fleet(n, seed=seed), **common)
    port = SelectionContext(rng=np.random.default_rng(seed),
                            fleet=sample_fleet(n, seed=seed), **common)
    return ref, port


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", SELECTOR_CASES, ids=str)
def test_selector_matches_reference(seed, method):
    """Three rounds in a row, so each Generator has advanced as far."""
    ref_ctx, ctx = _contexts(seed, s=1 + seed % 2)
    want_sel, got_sel = REF_SELECTORS.resolve(method), SELECTORS.resolve(
        method)
    assert got_sel.spec() == want_sel.spec()
    for attr in ("needs_rng", "needs_divergence"):
        assert getattr(got_sel, attr) == getattr(want_sel, attr)
    assert (getattr(got_sel, "needs_clusters", False)
            == getattr(want_sel, "needs_clusters", False))
    for _ in range(3):
        want = np.asarray(want_sel.select(ref_ctx))
        got = got_sel.select(ctx)
        np.testing.assert_array_equal(got, want)
        assert got.dtype.kind == "i"


def test_selectors_that_need_clusters_say_so():
    _, ctx = _contexts(0)
    ctx.clusters = None
    for name in ("kmeans_random", "divergence"):
        with pytest.raises(StrategyError, match="clusters"):
            SELECTORS.resolve(name).select(ctx)


@pytest.mark.parametrize("seed,c", [(0, 4), (1, 7)])
def test_kmeans_predict_matches_reference(seed, c):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(50, 33)).astype(np.float32)
    cent = rng.normal(size=(c, 33)).astype(np.float32)
    cent[1] = cent[0]                             # tied centroids
    want = np.asarray(ref_clustering.kmeans_predict(jnp.asarray(cent),
                                                    jnp.asarray(x)))
    got = kmeans_predict(torch.tensor(cent), torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# registry semantics (tests/test_api.py, on the port's registries)
# ---------------------------------------------------------------------------


def test_builtin_strategies_registered():
    assert set(SELECTORS.names()) == set(REF_SELECTORS.names())
    assert set(ALLOCATORS.names()) == set(REF_ALLOCATORS.names())
    from repro.api import AGGREGATORS as REF_AGGREGATORS
    assert AGGREGATORS.names() == REF_AGGREGATORS.names()
    from repro.api import CHANNELS as REF_CHANNELS
    from repro.api import COMPRESSORS as REF_COMPRESSORS
    from repro_torch.api.registry import CHANNELS, COMPRESSORS
    assert CHANNELS.names() == REF_CHANNELS.names()
    assert COMPRESSORS.names() == REF_COMPRESSORS.names()


def test_duplicate_registration_raises():
    reg = Registry("widget")

    @reg.register("x")
    class A:
        pass

    with pytest.raises(StrategyError, match="duplicate widget 'x'"):
        reg.register("x")(A)
    with pytest.raises(StrategyError, match="may not contain"):
        reg.register("a:b")


def test_unknown_name_raises_and_lists_known():
    with pytest.raises(StrategyError, match="unknown selector 'nope'"):
        SELECTORS.resolve("nope")
    with pytest.raises(StrategyError, match="divergence"):
        SELECTORS.get("nope")


@pytest.mark.parametrize("kind,name", [
    ("aggregator", "trimmed"), ("aggregator", "trimmed:0.2"),
    ("aggregator", "clipnorm:1.0"), ("aggregator", "clipnorm")])
def test_reference_strategies_the_port_lacks_name_the_port(kind, name):
    """The reference's strategies the port lacked (they raised naming the
    port) are ported: each resolves to the reference's parameters and
    folds the same rows as the reference does."""
    from repro.api import AGGREGATORS as REF_AGGREGATORS
    reg, ref_reg = {"aggregator": (AGGREGATORS, REF_AGGREGATORS)}[kind]
    got, want = reg.resolve(name), ref_reg.resolve(name)
    assert got.params() == want.params()
    assert ExperimentSpec(**{kind: name}).aggregator == {
        "name": name.partition(":")[0], "params": want.params()}
    rng = np.random.default_rng(1)
    g = rng.normal(scale=0.1, size=12).astype(np.float32)
    rows = (g + rng.normal(scale=0.1, size=(6, 12))).astype(np.float32)
    w = rng.uniform(1.0, 2.0, size=6).astype(np.float32)
    out, _ = got.aggregate_flat(torch.tensor(g), torch.tensor(rows),
                                torch.tensor(w), None)
    ref, _ = want.aggregate_flat(jnp.asarray(g), jnp.asarray(rows),
                                 jnp.asarray(w), None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_colon_shorthand_parses_params():
    assert ALLOCATORS.resolve("fedl:2.5").lam == 2.5
    assert ALLOCATORS.resolve("sao:box").box_correct is True
    assert ALLOCATORS.resolve("fedl_auto:24").iters == 24
    assert SELECTORS.resolve("rra:5").target_mean == 5
    assert SELECTORS.resolve("icas:0.3").beta == 0.3


def test_resolve_dict_and_instance():
    inst = ALLOCATORS.resolve({"name": "fedl", "params": {"lam": 3.0}})
    assert inst.lam == 3.0
    assert ALLOCATORS.resolve(inst) is inst
    with pytest.raises(StrategyError):
        ALLOCATORS.resolve(42)
    with pytest.raises(StrategyError, match="must have keys"):
        ALLOCATORS.resolve({"name": "sao", "parameters": {}})


def test_resolve_rejects_class_and_malformed_shorthand():
    cls = type(ALLOCATORS.resolve("sao"))
    with pytest.raises(StrategyError, match="pass an instance"):
        ALLOCATORS.resolve(cls)
    with pytest.raises(StrategyError, match="expected a number"):
        ALLOCATORS.resolve("fedl:abc")
    with pytest.raises(StrategyError, match="'box'"):
        ALLOCATORS.resolve("sao:garbage")
    with pytest.raises(StrategyError, match="takes no ':arg'"):
        SELECTORS.resolve("random:3")


def test_box_correct_kwarg_applies_to_resolved_allocator():
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.paper_cnn import CNN_CONFIGS
    from repro_torch.core.fedavg import FLExperiment
    from repro_torch.data.partition import partition_bias
    from repro_torch.data.synthetic import make_dataset

    ds = make_dataset("fashion", 96, seed=0)
    fed = partition_bias(ds, 6, 16, 0.8, seed=1)
    fl = FLConfig(num_devices=6, devices_per_round=3, num_clusters=3,
                  local_iters=1)
    args = (CNN_CONFIGS["fashion"], fed, ds.images[:20], ds.labels[:20],
            sample_fleet(6, seed=0), fl)
    for alloc in ("sao", {"name": "sao"}, ALLOCATORS.resolve("sao")):
        exp = FLExperiment(*args, allocator=alloc, box_correct=True,
                           batch_size=8, device="cpu")
        assert exp.allocator.box_correct is True
    with pytest.raises(ValueError, match="only applies to the 'sao'"):
        FLExperiment(*args, allocator="equal", box_correct=True,
                     batch_size=8, device="cpu")


def test_custom_registration_resolves():
    @SELECTORS.register("test_first_s")
    class FirstS:
        def select(self, ctx):
            return np.arange(ctx.devices_per_round)

        def params(self):
            return {}

        def spec(self):
            return {"name": "test_first_s", "params": {}}

    try:
        assert "test_first_s" in SELECTORS
        sel = SELECTORS.resolve("test_first_s")
        assert sel.select.__name__ == "select"
        assert ExperimentSpec(selection="test_first_s").selection == {
            "name": "test_first_s", "params": {}}
    finally:
        SELECTORS._classes.pop("test_first_s")


# ---------------------------------------------------------------------------
# ExperimentSpec
# ---------------------------------------------------------------------------


def test_spec_json_roundtrip():
    spec = ExperimentSpec(dataset="fashion", clients=12, sigma="H",
                          selection="icas", allocator="fedl:2.0",
                          test_seed=90_000)
    again = ExperimentSpec.from_json(spec.to_json())
    assert again == spec
    assert again.to_json() == spec.to_json()


@pytest.mark.parametrize("allocator", sorted(REF_ALLOCATORS.names())
                         + ["sao:box", "fedl:4.58", "fedl_auto:24"])
@pytest.mark.parametrize("selection", sorted(REF_SELECTORS.names()))
def test_every_reference_pair_resolves_and_round_trips(selection, allocator):
    """Every selector and allocator the reference registers resolves in the
    port's spec to the reference's canonical form, and survives JSON."""
    from repro.api import ExperimentSpec as RefSpec
    spec = ExperimentSpec(selection=selection, allocator=allocator)
    ref = RefSpec(selection=selection, allocator=allocator)
    assert spec.selection == ref.selection
    assert spec.allocator == ref.allocator
    assert ExperimentSpec.from_json(spec.to_json()) == spec


def test_spec_normalizes_compact_strings():
    spec = ExperimentSpec(allocator="fedl:2.0")
    assert spec.allocator == {"name": "fedl", "params": {"lam": 2.0}}
    assert spec.selection["name"] == "divergence"
    assert ExperimentSpec(allocator="fedl_auto").allocator == {
        "name": "fedl_auto", "params": {"iters": 12, "n_grid": 60}}


def test_spec_rejects_unknown_fields_newer_versions_and_strategies():
    with pytest.raises(ValueError, match="unknown ExperimentSpec fields"):
        ExperimentSpec.from_dict({"no_such_field": 1})
    with pytest.raises(ValueError, match="newer"):
        ExperimentSpec.from_dict({"version": 99})
    with pytest.raises(StrategyError):
        ExperimentSpec(selection="not_a_policy")


def test_spec_seed_derivation():
    spec = ExperimentSpec(seed=5)
    assert (spec.resolved_data_seed, spec.resolved_test_seed,
            spec.resolved_partition_seed, spec.resolved_fleet_seed) \
        == (5, 10_005, 6, 5)
    spec = ExperimentSpec(seed=5, data_seed=7, test_seed=90_000)
    assert (spec.resolved_data_seed, spec.resolved_test_seed) == (7, 90_000)


def test_allocation_returns_per_device_solution():
    exp = build_experiment(ExperimentSpec(**TINY), device="cpu")
    for name in ("sao", "sao:box", "equal", "fedl:1.0"):
        exp.allocator = ALLOCATORS.resolve(name)
        alloc = exp.allocation(np.arange(4))
        assert isinstance(alloc, Allocation)
        assert alloc.b.shape == (4,) and alloc.f.shape == (4,)
        assert bool(torch.all(alloc.b > 0)) and bool(torch.all(alloc.f > 0))


def test_empty_selection_is_a_no_op_round():
    """A selector that admits nobody: nothing trains, the global row does
    not move, T_k = E_k = 0 (the reference's explicit no-op round)."""
    class Nobody:
        registry_name = "nobody"

        def select(self, ctx):
            return np.array([], dtype=np.int64)

    exp = build_experiment(ExperimentSpec(**TINY), device="cpu")
    exp.initial_round()
    before = exp.global_vec.clone()
    res = exp.round(Nobody())
    assert res.selected.size == 0 and res.T_k == 0.0 and res.E_k == 0.0
    assert torch.equal(exp.global_vec, before)
    assert res.accuracy == exp.evaluate()[0]


@pytest.mark.parametrize("module", [
    "repro_torch.core.fedavg", "repro_torch.strategies",
    "repro_torch.core.baselines", "repro_torch.api.spec"])
def test_each_module_imports_first(module):
    """The strategies register through ``repro_torch.api``, which builds
    experiments of ``core.fedavg``: any of them imported first, in a fresh
    process, must not meet the others half-initialized."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run(
        [sys.executable, "-c", f"import {module}; import repro_torch.api; "
         "assert 'fedl_auto' in repro_torch.api.ALLOCATORS"],
        env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
