"""bifs_per_s: certified forms over the window,
from its start to the end of its last call."""
from quadbench.readers import certified_rate


def read(ctx):
    return certified_rate(ctx)
