"""iters_per_form.<cells>: quadrature iterations a form took (the solver's
own count, ``SolveResult.iterations``), averaged over the window's
forms."""


def read(ctx):
    if not ctx.window:
        return None
    its = [i for c in ctx.window for i in c["out"]["iterations"].tolist()]
    return sum(its) / len(its)
