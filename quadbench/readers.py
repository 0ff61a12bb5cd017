"""What the metric readers under ``metrics/`` share. A reader returns
None where its cell gives it nothing to read, and the harness then leaves
the metric out of the result line."""
from __future__ import annotations

import math


def certified_rate(ctx):
    """Certified units (forms) over the window: from its start to the end
    of its last call (calls started before the deadline run to their
    end)."""
    if not ctx.window:
        return None
    done = sum(ctx.kind.units(c["out"])[1] for c in ctx.window)
    return done / (ctx.window_end - ctx.window_start)


def latency_quantile_ms(ctx, q: float):
    """The nearest-rank q-quantile of the window's call latencies; a call
    with an uncertified answer counts as missing every limit (infinite),
    and where the quantile lands on one it reads the window's length."""
    if not ctx.window:
        return None
    def latency(c):
        attempted, certified = ctx.kind.units(c["out"])
        return c["t1"] - c["t0"] if attempted == certified else math.inf

    lat = sorted(latency(c) for c in ctx.window)
    v = lat[max(math.ceil(q * len(lat)) - 1, 0)]
    if not math.isfinite(v):
        v = ctx.window_end - ctx.window_start
    return 1e3 * v


def roofline_pct(ctx, kernel: str, names, launch_seconds):
    """A kernel's share of its roofline in the traced calls: the least
    time of its launches, ``launch_seconds(call) -> [seconds]``, over the
    device time of the operations named ``names``. None where the traced
    calls did not launch it."""
    if ctx.trace is None or not ctx.launches.get(kernel):
        return None
    device = ctx.trace.seconds_of(names)
    least = [s for c in ctx.profiled for s in launch_seconds(c["out"])]
    if device <= 0 or len(least) != ctx.launches[kernel]:
        return None
    return 100.0 * sum(least) / device
