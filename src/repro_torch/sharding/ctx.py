"""Opt-in activation sharding constraints (the port of
``repro.sharding.ctx``).

Model code calls ``constrain(x, kind)`` at the reference's places (the
embedded tokens, each block's output, the logits), and the dry run's
``--act-constraints`` enters :func:`activation_sharding` around a step, as
in the reference. The port has no SPMD partitioner and a tensor lies on
one device, where every sharding constraint is replication: ``constrain``
returns ``x`` itself inside a context as outside one, so a constrained
run is the unconstrained run bit for bit.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

_SPECS: contextvars.ContextVar[Optional[Dict]] = \
    contextvars.ContextVar("act_sharding_specs", default=None)


@contextlib.contextmanager
def activation_sharding(specs: Dict):
    """specs: kind -> PartitionSpec, e.g. {"act": P(("pod","data"), None),
    "logits": P(("pod","data"), None, "model")}."""
    token = _SPECS.set(specs)
    try:
        yield
    finally:
        _SPECS.reset(token)


def constrain(x, kind: str):
    """``x`` (of kind ``kind``): on one device every constraint is
    replication."""
    return x
