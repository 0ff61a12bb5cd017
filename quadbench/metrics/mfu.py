"""mfu.<cells>: the whole call's share of the card's peak: the least time
of the work its inputs need (quadbench/reckon.py) over the calls' wall
time, over the window's calls."""
from quadbench import reckon


def read(ctx):
    if not ctx.window:
        return None
    least = sum(reckon.least_seconds(*ctx.kind.reckon(c["out"]))
                for c in ctx.window)
    wall = sum(c["t1"] - c["t0"] for c in ctx.window)
    return 100.0 * least / wall
