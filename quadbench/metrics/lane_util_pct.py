"""lane_util_pct.<cells>: the share of the lane-steps the device computes
that the lanes use. Computed a call: the program's ``solver.lane_steps``
counter (``decide_every`` x the lanes, a round, frozen lanes included)
over its host loops, one a call (metrics/rounds_per_call.py), over every
call of the run. Used a call: the sum over a call's lanes of its
iterations less the one its init takes, from the answers the harness
keeps (the window's and the device-alone traced segment's calls)."""
from quadbench import rounds


def read(ctx):
    c = rounds.counters()
    calls = rounds.loops(c)
    if not ctx.window or calls <= 0:
        return None
    used, kept = rounds.used_steps(ctx.window + ctx.profiled)
    return rounds.lane_util_pct(used / kept, c["lane_steps"] / calls)
