"""Runtime observability, PyTorch port (counterpart of ``repro.obs``;
DESIGN.md Sec. 14). Host-side-only telemetry for the quadrature serving
stack:

``obs.metrics``
    process-local counters / gauges / log-scale histograms with exact
    p50/p90/p99 readout (stdlib-only).
``obs.spans``
    nestable monotonic-clock timing spans exporting Chrome-trace JSON
    (load a dump in https://ui.perfetto.dev), with an explicit
    ``block_until_ready`` hook (``torch.cuda.synchronize`` while the span
    is live) so asynchronous device work is attributed to the span that
    launched it; while ``torch.profiler`` records, a live span is also a
    ``record_function`` range on the profiler's clock. The solver's host
    loop (``core/solver.py``) records ``solver.*`` spans and counters.
``obs.registry``
    the driver-signature registry every engine driver in ``serve/``
    reports through (``registry.count("name")`` the first time a driver
    meets a new signature; ``retrace_counts()`` for one snapshot).
``obs.health``
    online convergence-health checks on recorded bracket gaps against
    the Thm. 4.2 contraction rate (the reorth-off failure mode).

THE CONTRACT: ``obs.metrics`` and ``obs.spans`` are written from HOST
code only, on values the scheduler already copied to the host, and spans
synchronise the card only while they are live. Telemetry therefore
cannot change results: solver brackets, decisions, iteration counts and
engine flush order are bit-identical with observability on or off
(pinned by tests/test_torch_obs.py). Nothing here imports torch at
module level.
"""
from . import health, metrics, registry, schema, spans
from .health import ContractionMonitor, ConvergenceLog, rate_bound
from .metrics import MetricsRegistry
from .registry import retrace_counts
from .spans import dump_trace, span, trace_events


def enable() -> None:
    """Turn on both metrics recording and span collection."""
    metrics.set_enabled(True)
    spans.set_enabled(True)


def disable() -> None:
    """Turn off metrics recording and span collection (the default for
    spans; metrics default on). Never affects ``obs.registry``: signature
    accounting is a contract signal, not telemetry."""
    metrics.set_enabled(False)
    spans.set_enabled(False)


__all__ = [
    "ContractionMonitor",
    "ConvergenceLog",
    "MetricsRegistry",
    "disable",
    "dump_trace",
    "enable",
    "health",
    "metrics",
    "rate_bound",
    "registry",
    "retrace_counts",
    "schema",
    "span",
    "spans",
    "trace_events",
]
