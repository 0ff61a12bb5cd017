"""call_p95_ms: the 95th percentile (nearest rank) of the window's call
latencies, each from the call's start to its answers on the host; a call
with an uncertified answer counts as missing every limit."""
from quadbench.readers import latency_quantile_ms


def read(ctx):
    return latency_quantile_ms(ctx, 0.95)
