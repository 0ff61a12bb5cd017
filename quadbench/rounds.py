"""The solver's decision rounds as the program records them: its
``solver.*`` counters in ``repro_torch.obs.metrics`` and its
``solver.round`` / ``solver.read`` spans in ``repro_torch.obs.spans``
(core/solver.py). Each function returns None where the program recorded
nothing, as a program without these counters and spans records."""
from __future__ import annotations

COUNTERS = ("rounds", "reads", "lane_steps")


def counters() -> dict:
    """The program's ``solver.*`` counters now, by their short names; 0
    for one it has not registered."""
    from repro_torch.obs import metrics
    got = metrics.snapshot()["counters"]
    return {k: got.get(f"solver.{k}", 0) for k in COUNTERS}


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in COUNTERS}


def loops(c: dict) -> int:
    """Host loops over rounds that ran to their end: each reads once more
    than it has rounds (one ``solve_batch`` call makes one)."""
    return c["reads"] - c["rounds"]


def rounds_per_call(c: dict, calls: int):
    if not c["rounds"] or calls <= 0:
        return None
    return c["rounds"] / calls


def lane_util_pct(used: float, lane_steps: float):
    """100 x the lane-steps the lanes used (each lane's iterations less
    the one its init takes) over those the device computed."""
    if lane_steps <= 0:
        return None
    return 100.0 * used / lane_steps


def used_steps(calls) -> tuple:
    """(lane-steps used, calls) over harness calls: the sum over their
    lanes of ``iterations - 1``."""
    its = [i for c in calls for i in c["out"]["iterations"].tolist()]
    return sum(i - 1 for i in its), len(calls)


def round_host_ms(events):
    """Mean over the ``solver.round`` span events of each one's duration
    less its ``solver.read`` child's: the host's time to launch a round.
    A round's read closes just before the round does, on its thread."""
    read, host = {}, []
    for e in events:
        if e["name"] == "solver.read" and \
                e["args"].get("parent") == "solver.round":
            read[e["tid"]] = e["dur"]
        elif e["name"] == "solver.round":
            host.append(e["dur"] - read.pop(e["tid"], 0.0))
    return sum(host) / len(host) / 1e3 if host else None
