"""fused_step_dense_roofline: K3 (``kernels.ops.fused_step_dense``) against
its roofline in the traced calls: the least time of each launch (the
operator's non-zero values, the live lanes' v and v_prev read and their
residual written, the live basis rows read; quadbench/reckon.py) over
the device time of K3's device functions."""
from quadbench import reckon
from quadbench.readers import roofline_pct

# K3's matvec routes and the fused tail (csrc/dense_step.cu, step_tail.cuh)
NAMES = ("dmma_matvec_kernel", "shared_matvec_kernel", "lane_matvec_kernel",
         "fused_tail_kernel")


def read(ctx):
    p, s = ctx.problem, ctx.kind.solver.config
    rows = s.max_iters + 1 if s.reorth else 0

    def launches(out):
        live = reckon.step_launches(out["iterations"].tolist())
        return [reckon.least_seconds(*reckon.fused_dense_launch(
            n_live, step, n=p["n"], nnz=p["nnz"], basis_rows=rows),
            "float64") for step, n_live in enumerate(live)]

    return roofline_pct(ctx, "fused_step_dense", NAMES, launches)
