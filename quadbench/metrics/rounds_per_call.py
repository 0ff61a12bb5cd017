"""rounds_per_call.<cells>: decision rounds a call, each one device-to-host
read, from the program's counters (core/solver.py): ``solver.rounds``
over the run's host loops, one a call (``solver.reads`` less
``solver.rounds``: a loop reads once more than it has rounds). The
harness reads them after the window, so they hold every call of the run:
the warm-up, the traced segments and the window, drawn alike."""
from quadbench import rounds


def read(ctx):
    c = rounds.counters()
    return rounds.rounds_per_call(c, rounds.loops(c))
