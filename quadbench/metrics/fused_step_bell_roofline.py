"""fused_step_bell_roofline: K4 (``kernels.ops.fused_step_bell``) against
its roofline in the traced calls: the least time of each launch (the f32
table's non-zero values, the live f64 lanes' v and v_prev read and their
residual written; quadbench/reckon.py) over the device time of K4's
device functions."""
from quadbench import reckon
from quadbench.readers import roofline_pct

# K4's blocked-ELL routes and the fused tail (csrc/bell.cu, step_tail.cuh)
NAMES = ("bell_dmma_kernel", "bell_fma_kernel", "bell_lane_kernel",
         "fused_tail_kernel")


def read(ctx):
    p = ctx.problem

    def launches(out):
        return [reckon.least_seconds(*reckon.fused_bell_launch(
            n_live, n=p["n"], nnz=p["nnz"]), "float64")
            for n_live in reckon.step_launches(out["iterations"].tolist())]

    return roofline_pct(ctx, "fused_step_bell", NAMES, launches)
