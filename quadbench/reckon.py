"""The least work of a call and of a kernel launch, reckoned from shapes and
the iterations taken, and the peaks of the card it is held to.

A reckoning counts what the inputs need and no more, so that no
implementation of the same iterations can beat it and a share of the
peak stays at or below 100%:

  * the operator's non-zero values read once a step (not the zeros a
    dense or blocked store holds, nor index bytes); its matvec 2 nnz
    flops a lane;
  * each lane vector read or written once an iteration: v and v_prev
    read, the next vector written (9 N flops of dots and updates);
  * with reorthogonalisation, the live basis rows read once and one row
    written a step (4 N flops a row);

Peaks: one H100 SXM (NVIDIA data sheet): HBM3 at 3.35 TB/s, 67 TFLOP/s
for f64 (FP64 tensor cores) and for f32 outside the tensor cores.
"""
from __future__ import annotations

import numpy as np

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time of the work: the larger of its bytes at the peak
    bandwidth and its flops at the type's peak rate."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])


def krylov_call(iterations, *, n: int, nnz: int, op_bytes: int,
                vec_bytes: int, reorth_rows: int = 0) -> tuple:
    """(bytes, flops) of one Krylov call whose lanes took ``iterations``
    (each counting the initial step). ``op_bytes`` is the size of one
    stored value, ``reorth_rows`` the basis rows kept (0: no
    reorthogonalisation)."""
    its = [int(i) for i in iterations]
    if not its:
        return 0.0, 0.0
    nbytes = max(its) * nnz * op_bytes
    flops = 0.0
    for it in its:
        nbytes += it * 3 * n * vec_bytes
        flops += it * (2 * nnz + 9 * n)
        if reorth_rows:
            rows = live_rows(it - 1, reorth_rows)
            nbytes += (rows + it - 1) * n * vec_bytes
            flops += 4 * rows * n
    return float(nbytes), float(flops)


def live_rows(steps: int, basis_rows: int) -> int:
    """Basis rows live over ``steps`` reorthogonalised steps: before step
    s the rows 0 .. min(s + 2, M) - 1 hold vectors."""
    ramp = max(min(steps, basis_rows - 2), 0)     # steps with s + 2 <= M
    return ramp * (ramp + 3) // 2 + (steps - ramp) * basis_rows


def step_launches(iterations) -> list:
    """The live lanes of each launch of a per-step kernel: lane i takes
    ``iterations[i] - 1`` steps after its initial one."""
    steps = np.asarray(iterations, dtype=np.int64).reshape(-1) - 1
    if steps.size == 0:
        return []
    # live[s] = lanes with more than s steps
    count = np.bincount(np.clip(steps, 0, None))
    live = (count[::-1].cumsum()[::-1][1:]).tolist()
    return [int(x) for x in live]


def fused_dense_launch(live: int, step: int, *, n: int, nnz: int,
                       basis_rows: int) -> tuple:
    """(bytes, flops) of one K3 launch (``fused_step_dense``) at ``step``
    over ``live`` lanes, f64: the operator's values, v and v_prev read and
    the residual written, the live basis rows read."""
    rows = min(step + 2, basis_rows) if basis_rows else 0
    nbytes = nnz * 8 + live * (3 + rows) * n * 8
    flops = live * (2 * nnz + 4 * rows * n + 9 * n)
    return float(nbytes), float(flops)


def fused_bell_launch(live: int, *, n: int, nnz: int) -> tuple:
    """(bytes, flops) of one K4 launch (``fused_step_bell``) over ``live``
    f64 lanes of an f32 table."""
    return float(nnz * 4 + live * 3 * n * 8), \
        float(live * (2 * nnz + 9 * n))
