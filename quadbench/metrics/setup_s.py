"""setup_s: seconds from the process's start to the measured window:
imports, CUDA start, the problem made on the card (and its spectral
interval), the kernels' build where the checkout has none yet, and one
warm call of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
