"""The frozen work reckonings pinned to hand counts at small shapes, and the
device-trace arithmetic on hand-made events."""
import pytest

from quadbench import reckon
from quadbench.devtrace import DeviceTrace, clean


def test_least_seconds_takes_the_binding_peak():
    assert reckon.least_seconds(3.35e12, 0.0, "float64") == 1.0
    assert reckon.least_seconds(0.0, 67e12, "float32") == 1.0
    assert reckon.least_seconds(3.35e12, 134e12, "float64") == 2.0


def test_krylov_call_hand_count():
    # two lanes of 2 and 3 iterations, n = 10, 25 non-zeros in f64
    nb, fl = reckon.krylov_call([2, 3], n=10, nnz=25, op_bytes=8,
                                vec_bytes=8)
    assert nb == 3 * 25 * 8 + (2 + 3) * 3 * 10 * 8
    assert fl == (2 + 3) * (2 * 25 + 9 * 10)


def test_krylov_call_reorth_hand_count():
    # one lane of 4 iterations (3 steps), basis of 4 rows: before steps
    # 0, 1, 2 the live rows are 2, 3, 4
    nb, fl = reckon.krylov_call([4], n=10, nnz=25, op_bytes=4,
                                vec_bytes=8, reorth_rows=4)
    rows = 2 + 3 + 4
    assert nb == 4 * 25 * 4 + 4 * 3 * 10 * 8 + (rows + 3) * 10 * 8
    assert fl == 4 * (2 * 25 + 9 * 10) + 4 * rows * 10


@pytest.mark.parametrize("steps,rows", [(0, 5), (1, 5), (3, 5), (4, 5),
                                        (10, 5), (7, 161), (200, 161)])
def test_live_rows_sums_the_ramp(steps, rows):
    assert reckon.live_rows(steps, rows) == sum(min(s + 2, rows)
                                                for s in range(steps))


def test_step_launches_counts_live_lanes():
    assert reckon.step_launches([3, 1, 2]) == [2, 1]
    assert reckon.step_launches([1, 1]) == []


def test_kernel_launch_hand_counts():
    nb, fl = reckon.fused_dense_launch(2, 1, n=10, nnz=25, basis_rows=8)
    assert (nb, fl) == (25 * 8 + 2 * (3 + 3) * 10 * 8,
                        2 * (2 * 25 + 4 * 3 * 10 + 9 * 10))
    nb, fl = reckon.fused_dense_launch(2, 9, n=10, nnz=25, basis_rows=0)
    assert (nb, fl) == (25 * 8 + 2 * 3 * 10 * 8, 2 * (2 * 25 + 9 * 10))
    assert reckon.fused_bell_launch(3, n=10, nnz=25) == (
        25 * 4 + 3 * 3 * 10 * 8, 3 * (2 * 25 + 9 * 10))


def test_device_trace_union_names_and_gaps():
    ops = [(10, 20, "k1"), (15, 30, "k2"), (50, 60, "k1"), (90, 99, "k3")]
    host = [(0, 100, "call"), (32, 45, "aten::add"), (33, 40, "launch"),
            (70, 80, "aten::item")]
    t = DeviceTrace(ops, host, (5, 95))
    assert t.busy == [[10, 30], [50, 60], [90, 95]]
    assert t.busy_s == pytest.approx(35e-9)
    assert t.window_s == pytest.approx(90e-9)
    assert t.seconds_by_name() == pytest.approx(
        {"k1": 20e-9, "k2": 15e-9, "k3": 5e-9})
    assert t.seconds_of(("k1", "k3")) == pytest.approx(25e-9)
    # gaps [5, 10) in "call", [30, 50) at 40 in "launch", [60, 90) at 75
    # in "aten::item"
    assert t.idle_gaps() == pytest.approx(
        {"call": 5e-9, "launch": 20e-9, "aten::item": 30e-9})
    assert t.breakdown(top=1) == {"device_ops": [["k1", 20e-9]],
                                  "idle_gaps": [["aten::item", 30e-9]]}


def test_clean_kernel_names():
    assert clean("void (anonymous namespace)::dmma_matvec_kernel<double, "
                 "64>(Args)") == "dmma_matvec_kernel"
    assert clean("sytrd4_gpu") == "sytrd4_gpu"
