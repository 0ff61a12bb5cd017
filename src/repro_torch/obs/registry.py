"""Central driver-signature registry (counterpart of
``repro.obs.registry``, the same names).

In the reference every module-level jit in ``serve/`` calls
``count("name")`` inside its traced body, so the count rises once per
compile. Torch has no trace: in the port ``count`` counts DISTINCT DRIVER
SIGNATURES, not compiles. Each engine driver keeps a set of the keys a
jit cache would key on (solver config, operator kind and shapes, pool
shape, dtype, device) and calls ``count`` the first time it meets a key,
never on reuse. So the contract the tests pin holds in both packages:
``serve.engine.flush_trace_count()`` rises once per new signature and
never when a signature repeats (padding-bucket reuse).

Deliberately NOT gated by ``obs.metrics.set_enabled``: these counts are
a contract signal, not optional telemetry.
"""
from __future__ import annotations

import threading

_LOCK = threading.Lock()
_COUNTS: dict = {}


def count(name: str) -> int:
    """Record one new signature of ``name``; returns the new count."""
    with _LOCK:
        c = _COUNTS.get(name, 0) + 1
        _COUNTS[name] = c
        return c


def value(name: str) -> int:
    """Current count for ``name`` (0 if never counted)."""
    return _COUNTS.get(name, 0)


def retrace_counts() -> dict:
    """One snapshot of every registered counter."""
    with _LOCK:
        return dict(sorted(_COUNTS.items()))


def reset() -> None:
    with _LOCK:
        _COUNTS.clear()
