"""idle_pct.<cells>: the share of the traced calls' window in which no
operation (kernel, copy or fill) ran on the card, from a trace of the
device's activity alone (no host events recorded)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
