"""Fault injection for the FL runtime — the failure modes a wireless fleet
exhibits, declared once and injected on every way to run rounds (the
device-resident run and the host loop, dense and paged, synchronous and
asynchronous), as ``repro.core.faults`` declares them:

``outage``
    A dispatched client's upload is lost with probability ``outage``
    (i.i.d. per dispatch). The client trained and its completion was
    priced, but its row never reaches the server: it is weighted out of
    the fold and never written to the store.

``chan_outage``
    The upload fails exactly when the round's small-scale fade is deep:
    the Gauss-Markov carry's ``|h_t|²`` is unit-mean exponential, so
    dropping below ``−ln(1 − rate)`` gives the configured marginal rate
    while deep fades cause the drops. Needs a stateful channel.

``corrupt``
    The upload arrives as garbage: the row becomes NaN. The server's
    non-finite guard weights it out, counts a STRIKE against its sender
    (``ClientStats.strikes``) and never stores it; ``quarantine_after``
    strikes keep a client out of selection.

``byzantine``
    A FIXED subset of clients (fraction ``byzantine``, drawn once from
    ``seed``) sends ``g − byz_scale·(w − g)``: finite, so the guard does
    not see it; ``trimmed:f`` and ``clipnorm:c`` are the defence.

``deadline``
    A priced completion time (eqs. 5+8) above ``deadline`` seconds is a
    straggler the server stops waiting for: dropped like an outage.

Rates are per-dispatch probabilities in [0, 1]. ``FaultSpec`` is frozen
(hashable: it keys the captured programs) and its compact spelling
``"outage:0.1,corrupt:0.01"`` round-trips through ``from_string`` /
``to_dict``. The draws come from the experiment's draws object
(``repro_torch.core.draws.TorchDraws``), never from ``jax.random``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["FaultSpec", "FAULT_KINDS", "byzantine_clients",
           "draw_fault_masks", "chan_outage_threshold"]


#: the fault kinds the compact spelling accepts (field name → doc)
FAULT_KINDS: Dict[str, str] = {
    "outage": "P(upload lost) per dispatch, i.i.d.",
    "chan_outage": "marginal P(upload lost) derived from the fade state",
    "corrupt": "P(payload arrives non-finite) per dispatch",
    "byzantine": "fraction of clients sending adversarial updates",
    "byz_scale": "amplification of the byzantine negated update",
    "deadline": "drop updates whose priced completion exceeds this [s]",
    "seed": "PRNG decorrelator for the byzantine subset",
}

_RATE_FIELDS = ("outage", "chan_outage", "corrupt", "byzantine")


@dataclass(frozen=True)
class FaultSpec:
    """Declarative fault model — hashable, JSON-round-trippable."""

    outage: float = 0.0
    chan_outage: float = 0.0
    corrupt: float = 0.0
    byzantine: float = 0.0
    byz_scale: float = 5.0
    deadline: float = 0.0
    seed: int = 0

    def __post_init__(self):
        for name in _RATE_FIELDS:
            v = float(getattr(self, name))
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"fault rate {name!r} must lie in [0, 1]; got {v}")
            object.__setattr__(self, name, v)
        if not (np.isfinite(self.byz_scale) and self.byz_scale >= 0.0):
            raise ValueError(f"byz_scale must be finite and >= 0; got "
                             f"{self.byz_scale}")
        if self.deadline < 0.0:
            raise ValueError(f"deadline must be >= 0 seconds; got "
                             f"{self.deadline}")
        object.__setattr__(self, "byz_scale", float(self.byz_scale))
        object.__setattr__(self, "deadline", float(self.deadline))
        object.__setattr__(self, "seed", int(self.seed))

    @property
    def active(self) -> bool:
        return (self.outage > 0.0 or self.chan_outage > 0.0
                or self.corrupt > 0.0 or self.byzantine > 0.0
                or self.deadline > 0.0)

    @classmethod
    def from_string(cls, s: str) -> "FaultSpec":
        """``"outage:0.1,corrupt:0.01"`` → FaultSpec; an unknown kind
        raises naming the registered ones."""
        kw: Dict[str, Any] = {}
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            kind, sep, val = part.partition(":")
            kind = kind.strip().replace("-", "_")
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; registered kinds: "
                    f"{sorted(FAULT_KINDS)}")
            if not sep:
                raise ValueError(
                    f"fault kind {kind!r} needs a value: '{kind}:RATE'")
            try:
                kw[kind] = int(val) if kind == "seed" else float(val)
            except ValueError:
                raise ValueError(
                    f"fault kind {kind!r}: expected a number, got "
                    f"{val!r}") from None
        return cls(**kw)

    @classmethod
    def normalize(cls, ref: Any) -> Optional["FaultSpec"]:
        """None | FaultSpec | dict | compact string → FaultSpec | None."""
        if ref is None or isinstance(ref, FaultSpec):
            return ref
        if isinstance(ref, str):
            return cls.from_string(ref)
        if isinstance(ref, dict):
            unknown = set(ref) - set(FAULT_KINDS)
            if unknown:
                raise ValueError(
                    f"unknown fault kinds {sorted(unknown)}; registered "
                    f"kinds: {sorted(FAULT_KINDS)}")
            return cls(**ref)
        raise TypeError(f"cannot build a FaultSpec from {type(ref).__name__}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def byzantine_clients(spec: FaultSpec, num_clients: int,
                      draws) -> np.ndarray:
    """The fixed adversarial subset as a host ``[N]`` bool mask: a
    Bernoulli(byzantine) draw from ``spec.seed`` (``draws.byzantine``, a
    stream of its own, so every way to run rounds agrees on who the
    adversaries are)."""
    if spec.byzantine <= 0.0:
        return np.zeros(num_clients, bool)
    return np.asarray(draws.byzantine(spec, num_clients), dtype=bool)


def draw_fault_masks(spec: FaultSpec, shape, draws):
    """One dispatch's stochastic faults: a ``[2, *shape]`` bool tensor,
    the drop mask then the corrupt mask (one lane a dispatched client),
    from ``draws.fault_masks``. A spec with an outage or corrupt rate
    takes the same draws whatever the rates, so the stream stays in step
    on every way to run rounds; a spec with neither (deadline, byzantine
    or channel outages alone) takes none, so a deadline that drops
    nothing leaves the run as it was. The channel-coupled and deadline
    drops are OR-ed in by the caller."""
    if spec.outage <= 0.0 and spec.corrupt <= 0.0:
        return torch.zeros((2,) + tuple(shape), dtype=torch.bool,
                           device=getattr(draws, "device", "cpu"))
    return draws.fault_masks(spec, tuple(shape))


def chan_outage_threshold(rate: float) -> float:
    """The fade-power cut with marginal outage probability ``rate``: the
    Gauss-Markov gain ``|h_t|²`` is unit-mean exponential at every lag,
    so ``P(gain < −ln(1 − rate)) = rate``."""
    return float(-math.log1p(-min(rate, 1.0 - 1e-12)))
