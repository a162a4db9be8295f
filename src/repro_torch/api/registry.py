"""Strategy registries — one per swappable stage of the round loop (Fig. 2):
device selection, spectrum allocation, aggregation and uplink compression,
plus the physical channel models (``repro.api.registry``). A strategy is a small class registered under a
short name:

    from repro_torch.api import SELECTORS

    @SELECTORS.register("my_policy")
    @dataclass(frozen=True)
    class MySelector:
        def select(self, ctx):            # ctx: api.protocols.SelectionContext
            ...

Resolution accepts a bare name (``"sao"``), the ``name:arg`` shorthand
(``"fedl:2.0"``, fed to the class's ``from_string`` hook), a
``{"name", "params"}`` dict and an instance (returned as it is).

Each registry holds what the port implements. A name it lacks — one of
the reference's strategies not yet ported, or none at all — raises a
:class:`StrategyError` that lists what the port has.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Type


class StrategyError(ValueError):
    """Registry lookup / registration failure."""


class Strategy:
    """Optional base for registered strategies (dataclasses recommended).

    ``params()`` returns the JSON-able constructor kwargs and ``spec()``
    the canonical ``{"name", "params"}`` dict an ``ExperimentSpec`` stores.
    """

    registry_name: str = "?"          # set by Registry.register

    @classmethod
    def from_string(cls, arg: Optional[str]) -> "Strategy":
        """Build from the ``name:arg`` shorthand: ``arg`` goes to the first
        dataclass field (as a number where the field is one)."""
        if arg is None or arg == "":
            return cls()
        fields = (dataclasses.fields(cls) if dataclasses.is_dataclass(cls)
                  else ())
        if not fields:
            raise StrategyError(
                f"{cls.registry_name!r} takes no ':arg' parameter (got "
                f"{arg!r})")
        f0 = fields[0]
        value: Any = arg
        if f0.type in ("float", "int", float, int):
            try:
                value = int(arg) if f0.type in ("int", int) else float(arg)
            except ValueError:
                raise StrategyError(
                    f"{cls.registry_name}:{arg}: expected a number for "
                    f"{f0.name!r}") from None
        return cls(**{f0.name: value})

    def params(self) -> Dict[str, Any]:
        if dataclasses.is_dataclass(self):
            return {f.name: getattr(self, f.name)
                    for f in dataclasses.fields(self) if f.init}
        return {}

    def spec(self) -> Dict[str, Any]:
        return {"name": self.registry_name, "params": self.params()}


class Registry:
    """Name → strategy class for one stage of the round loop."""

    def __init__(self, kind: str):
        self.kind = kind
        self._classes: Dict[str, Type] = {}

    def register(self, name: str) -> Callable[[Type], Type]:
        if ":" in name:
            raise StrategyError(f"{self.kind} name {name!r} may not contain "
                                "':'")

        def deco(cls: Type) -> Type:
            if name in self._classes:
                raise StrategyError(
                    f"duplicate {self.kind} {name!r} (already registered to "
                    f"{self._classes[name].__qualname__})")
            self._classes[name] = cls
            cls.registry_name = name
            return cls

        return deco

    def get(self, name: str) -> Type:
        try:
            return self._classes[name]
        except KeyError:
            raise StrategyError(
                f"unknown {self.kind} {name!r}: not registered in the port, "
                f"which has {self.names()}") from None

    def names(self) -> List[str]:
        return sorted(self._classes)

    def __contains__(self, name: str) -> bool:
        return name in self._classes

    def resolve(self, spec: Any):
        """A strategy instance for a name, ``name:arg``, ``{"name",
        "params"}`` dict or instance."""
        if isinstance(spec, str):
            name, _, arg = spec.partition(":")
            cls = self.get(name)
            if hasattr(cls, "from_string"):
                return cls.from_string(arg or None)
            if arg:
                raise StrategyError(
                    f"{self.kind} {name!r} has no from_string hook for the "
                    f"':{arg}' shorthand")
            return cls()
        if isinstance(spec, dict):
            extra = set(spec) - {"name", "params"}
            if "name" not in spec or extra:
                raise StrategyError(
                    f"{self.kind} dict must have keys {{'name', 'params'}}; "
                    f"got {sorted(spec)}")
            return self.get(spec["name"])(**spec.get("params", {}))
        if isinstance(spec, type):
            raise StrategyError(
                f"got the {self.kind} class {spec.__name__}; pass an "
                f"instance ({spec.__name__}(...)) or its registered name")
        if hasattr(spec, "registry_name"):       # already an instance
            return spec
        raise StrategyError(
            f"cannot resolve {self.kind} from {type(spec).__name__}: "
            f"{spec!r}")

    def canonical(self, spec: Any) -> Dict[str, Any]:
        """The ``{"name", "params"}`` form (``ExperimentSpec`` storage)."""
        return self.resolve(spec).spec()


SELECTORS = Registry("selector")
ALLOCATORS = Registry("allocator")
AGGREGATORS = Registry("aggregator")
COMPRESSORS = Registry("compressor")
CHANNELS = Registry("channel")

_BY_KIND = {r.kind: r for r in (SELECTORS, ALLOCATORS, AGGREGATORS,
                                COMPRESSORS, CHANNELS)}


def register_channel(name: str):
    """Register a channel model under ``name`` (``CHANNELS.register``, the
    scenario API's entry point)."""
    return CHANNELS.register(name)


def get_registry(kind: str) -> Registry:
    try:
        return _BY_KIND[kind]
    except KeyError:
        raise StrategyError(
            f"unknown registry kind {kind!r}; the port has "
            f"{sorted(_BY_KIND)}") from None
