"""Each cell's traffic and reference on the CPU, at a small size, through
the program's plain path: a sound run is correct; the control (the
program's own float32 path) and each fault the cell can have planted
under the timed path are not."""
import dataclasses
import time
from pathlib import Path

import pytest
import torch

from quadbench import harness

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 12345        # larger than 32 signed bits hold
SMALL = {
    "rbf-gp-variance": {"config": {"n": 300},
                        "traffic": {"lanes": 8, "profile_calls": 1}},
    "lap-gmrf-variance": {"config": {"n": 512, "edges": 1416},
                          "traffic": {"lanes": 64, "profile_calls": 1}},
}
CELLS = sorted(SMALL)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run(cell, trace=False, control=False, calls=2):
    return harness.run_cell(ROOT, cell, SEED, 30.0, trace,
                            torch.device("cpu"), t_start=time.perf_counter(),
                            overrides=SMALL[cell], max_calls=calls,
                            control=control)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, trace):
    out = run(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    man = harness.manifest(ROOT)
    want = {m["name"] for m in harness.metrics_for(man, cell, trace)}
    if not trace:
        # every end-to-end metric reads on the CPU too (host clock)
        assert set(out["metrics"]) == want
    else:
        # device readings need the card; the counts and mfu do not
        assert set(out["metrics"]) <= want
        assert any(k.startswith("mfu.") for k in out["metrics"])
        assert out["device"]["window_s"] > 0
        # the device-only segment and the host-traced one, side by side
        assert set(out["traced"]) == {"device_only", "with_host",
                                      "untraced_ms_per_call"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = run(cell, control=True)
    assert out["correct"]
    over = [k for k, c in out["control"].items() if c["value"] > c["limit"]]
    assert over, out["control"]


def _stuck_stepper(self):
    """A step that returns its state unchanged but for its count."""
    def step(op, st, lam_min, lam_max, basis=None, rows=None):
        if dataclasses.is_dataclass(st):
            return dataclasses.replace(st, it=st.it + 1)
        return st._replace(it=st.it + 1)
    return step


def _half_batch(orig):
    """Half of the lanes left out: the rest are solved, and the answer
    holds only them (a trace then takes its mean over the rest)."""
    def solve_batch(self, op, u, *a, **k):
        return orig(self, op, u[: u.shape[0] // 2], *a, **k)
    return solve_batch


def _altered(orig):
    """An answer altered where it is produced: one lane's bracket moved
    up by a thousandth of itself."""
    def solve_batch(self, *a, **k):
        res = orig(self, *a, **k)
        lo, hi = res.lower.clone(), res.upper.clone()
        lo[..., 0] *= 1.001
        hi[..., 0] *= 1.001
        return res._replace(lower=lo, upper=hi)
    return solve_batch


FAULTS = ["stuck_step", "half_batch", "altered_answer"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    from repro_torch.core import solver as solver_mod
    cls = solver_mod.BIFSolver
    if fault == "stuck_step":
        monkeypatch.setattr(cls, "_stepper", _stuck_stepper)
    elif fault == "half_batch":
        monkeypatch.setattr(cls, "solve_batch", _half_batch(cls.solve_batch))
    else:
        monkeypatch.setattr(cls, "solve_batch", _altered(cls.solve_batch))
    out = run(cell, calls=1)
    assert not out["correct"], out["checks"]
