"""The strategies the port runs: the ``divergence`` selector, the ``sao``
allocator and the ``fedavg`` aggregator (the ``ExperimentSpec`` defaults).

A strategy reference is a bare name, a ``{"name", "params"}`` dict or an
instance; anything else raises a ``ValueError`` that names what the port
supports.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.strategies.aggregators import FedAvgAggregator
from repro_torch.strategies.allocators import SAOAllocator
from repro_torch.strategies.selectors import DivergenceSelector

SUPPORTED = {
    "selector": {"divergence": DivergenceSelector},
    "allocator": {"sao": SAOAllocator},
    "aggregator": {"fedavg": FedAvgAggregator},
}


def canonical(kind: str, ref: Any) -> Dict[str, Any]:
    """The ``{"name", "params"}`` form of ``ref`` (how ``ExperimentSpec``
    stores it); raises ``ValueError`` for anything the port lacks."""
    table = SUPPORTED[kind]
    if isinstance(ref, dict):
        name, params = ref.get("name"), dict(ref.get("params") or {})
    elif isinstance(ref, str):
        name, params = ref, {}
    else:
        name, params = getattr(ref, "registry_name", None), {}
    if name not in table or params:
        raise ValueError(f"{kind} {ref!r} is not in the port; supported: "
                         f"{sorted(table)} (without arguments)")
    return {"name": name, "params": {}}


def resolve(kind: str, ref: Any):
    """A strategy instance for ``ref`` (every supported one is stateless,
    so a fresh instance is as good as the one passed in)."""
    return SUPPORTED[kind][canonical(kind, ref)["name"]]()
