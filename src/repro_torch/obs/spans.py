"""Nestable monotonic-clock timing spans with Chrome-trace export
(counterpart of ``repro.obs.spans``, the same names).

``with span("engine.flush"):`` times a region on ``time.monotonic()``;
completed spans accumulate as Chrome-trace "complete" events ("ph": "X",
microsecond ts/dur) and :func:`dump_trace` writes the standard JSON
object wrapper; load it in https://ui.perfetto.dev or chrome://tracing.
Nesting is by timestamp containment per thread, which is exactly how the
trace viewers reconstruct the flame graph.

THE ATTRIBUTION CAVEAT: CUDA launches are asynchronous. A span that only
wraps the call that LAUNCHES device work closes long before the card
finishes, and the wall time shows up in whichever later span happens to
wait on the result (usually an innocent ``.cpu()``). Use the span's
:meth:`Span.block_until_ready` hook on the launched values to charge the
device time to the span that caused it::

    with span("engine.pool_step") as sp:
        state, lo, hi = step(state)
        sp.block_until_ready((lo, hi))

It synchronises the devices of the CUDA tensors it is given, and only
while the span is live: with spans off it does nothing, so telemetry
cannot change timing or results.

Collection is OFF by default (a long-running service would accumulate
events without bound): ``set_enabled(True)`` or ``obs.enable()`` turns
it on. Host-side only.
"""
from __future__ import annotations

import json
import os
import threading
import time

_LOCK = threading.RLock()
_ENABLED = [False]
_EVENTS: list = []
_EPOCH = time.monotonic()  # trace timestamps are relative to import
_TLS = threading.local()


def set_enabled(flag: bool) -> None:
    _ENABLED[0] = bool(flag)


def enabled() -> bool:
    return _ENABLED[0]


class Span:
    """One timed region; use via the :func:`span` context manager."""

    __slots__ = ("name", "args", "_t0", "_depth", "_live")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._depth = 0
        self._live = False

    def __enter__(self) -> "Span":
        if _ENABLED[0]:
            self._live = True
            stack = getattr(_TLS, "stack", None)
            if stack is None:
                stack = _TLS.stack = []
            self._depth = len(stack)
            stack.append(self)
            self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._live:
            return
        t1 = time.monotonic()
        _TLS.stack.pop()
        self._live = False
        args = dict(self.args)
        args["depth"] = self._depth
        if exc_type is not None:
            args["error"] = exc_type.__name__
        event = {
            "name": self.name,
            "cat": "obs",
            "ph": "X",
            "ts": (self._t0 - _EPOCH) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": args,
        }
        with _LOCK:
            _EVENTS.append(event)

    def block_until_ready(self, value):
        """Wait for the in-flight device work behind ``value`` (tensors,
        possibly nested in tuples, lists or dicts) so that it
        is charged to THIS span: one ``torch.cuda.synchronize`` per CUDA
        device among them, and nothing when the span is not live (span
        collection off) or no tensor lies on a card. Returns ``value``
        unchanged; never alters results."""
        if self._live:
            devices = set()
            _cuda_devices(value, devices)
            if devices:
                import torch
                for dev in sorted(devices, key=str):
                    torch.cuda.synchronize(dev)
        return value


def _cuda_devices(value, out: set) -> None:
    """Collect the CUDA devices of the tensors in ``value`` (duck-typed, so
    this module imports no torch)."""
    if value is None:
        return
    dev = getattr(value, "device", None)
    if dev is not None and getattr(dev, "type", None) == "cuda":
        out.add(dev)
        return
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)


def span(name: str, **args) -> Span:
    """``with span("engine.flush", mode="continuous"): ...``"""
    return Span(name, **args)


def trace_events() -> list:
    """Copy of the accumulated Chrome-trace events."""
    with _LOCK:
        return list(_EVENTS)


def reset() -> None:
    with _LOCK:
        _EVENTS.clear()


def dump_trace(path: str) -> dict:
    """Write the accumulated spans as Chrome-trace JSON (object form)
    and return the written document."""
    with _LOCK:
        doc = {
            "traceEvents": list(_EVENTS),
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "repro_torch.obs.spans",
                "clock": "monotonic-since-import",
            },
        }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc
