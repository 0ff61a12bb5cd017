"""The device trace of a traced run, read from ``torch.profiler``'s events
in memory (nothing is written to disk).

``profiled`` runs calls under the profiler, either recording the device's
activity alone (the window is then the host clock's span between two
synchronisations), or the host's operators too, inside a named window
span. Recording the host's operators slows a loop whose pace the host
sets, so busy and idle shares are read from a trace of the device alone,
and the host's trace only says what the host was doing in each idle gap.
``DeviceTrace`` holds the window, every device operation (kernels, copies,
fills) in it, and the host events, and answers the questions the
per-layer readers ask: busy seconds (the union of the device operations'
intervals), device seconds by operation name, and the idle gaps by what
the host was doing (the innermost host event at each gap's middle).
"""
from __future__ import annotations

import contextlib

WINDOW = "quadbench.window"


def clean(name: str) -> str:
    """A kernel's bare function name: no return type, namespace, template
    or argument list."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class DeviceTrace:
    """``ops``: (start_ns, end_ns, name) of device operations, ``host``:
    (start_ns, end_ns, name) of host events, ``window``: (start_ns,
    end_ns). Operations are clipped to the window."""

    def __init__(self, ops, host, window):
        self.window = window
        w0, w1 = window
        self.ops = [(max(a, w0), min(b, w1), n) for a, b, n in ops
                    if b > w0 and a < w1]
        # outer events first where two start together
        self.host = sorted(((a, b, n) for a, b, n in host
                            if b > w0 and a < w1),
                           key=lambda h: (h[0], -h[1]))
        self.busy = _union((a, b) for a, b, _ in self.ops)

    @classmethod
    def from_profiler(cls, prof, span_ns=None):
        """From a finished profile: the device operations, and the host
        events of the thread that opened the window span. A profile of the
        device alone has no window span: its window starts at its first
        operation and lasts ``span_ns``, measured on the host."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        ops, host, window, thread = [], [], None, None
        for e in prof.profiler.kineto_results.events():
            span = (e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == cuda:
                # the window span's device-side twin is no operation
                if e.name() != WINDOW:
                    ops.append(span + (clean(e.name()),))
            elif e.name() == WINDOW:
                window, thread = span, e.start_thread_id()
            else:
                host.append(span + (e.name(), e.start_thread_id()))
        if window is None and span_ns is not None:
            start = min((a for a, _, _ in ops), default=0)
            window = (start, start + int(span_ns))
        if window is None:
            raise RuntimeError("the profiler recorded no window span")
        return cls(ops, [h[:3] for h in host if h[3] == thread], window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def seconds_by_name(self) -> dict:
        out = {}
        for a, b, n in self.ops:
            out[n] = out.get(n, 0.0) + (b - a) / 1e9
        return out

    def seconds_of(self, patterns) -> float:
        """Device seconds of the operations whose name contains any of
        ``patterns``."""
        return sum(s for n, s in self.seconds_by_name().items()
                   if any(p in n for p in patterns))

    def idle_gaps(self) -> dict:
        """Idle device seconds in the window by the innermost host event
        at each gap's middle ("host, no event" where none is open)."""
        w0, w1 = self.window
        edges = [w0] + [x for ab in self.busy for x in ab] + [w1]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        out, stack, j, host = {}, [], 0, self.host
        # one sweep: the host events of one thread nest, so the innermost
        # event open at a time is the last opened that has not closed
        for a, b in gaps:
            mid = (a + b) // 2
            while j < len(host) and host[j][0] <= mid:
                while stack and stack[-1][1] < host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "host, no event"
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
        return out

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(self.seconds_by_name()),
                "idle_gaps": head(self.idle_gaps())}


@contextlib.contextmanager
def profiled(host: bool):
    """Profile the device, and with ``host`` the host's operators inside a
    window span; yields a dict whose ``"trace"`` is the ``DeviceTrace``
    once the block has ended. Without a card the host is recorded
    either way (there is no device activity to record)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    out = {}
    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if card else []
    if host or not card:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        if card:
            torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        with record_function(WINDOW):
            yield out
            if card:
                torch.cuda.synchronize()
        span = time.perf_counter_ns() - t0
    out["trace"] = DeviceTrace.from_profiler(
        prof, span_ns=None if ProfilerActivity.CPU in acts else span)
