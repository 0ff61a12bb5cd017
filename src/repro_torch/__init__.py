"""PyTorch/CUDA port of ``repro`` (Gauss quadrature for matrix inverse
forms), slice by slice; ``repro`` stays the reference it is held to.

``core`` holds the operators, Lanczos, the Alg. 5 recurrence, the
matrix-function and block-Krylov brackets, the Alg. 2 solver and the
stochastic trace; ``kernels`` the hand-written Hopper kernels K1-K7 with
their plain PyTorch versions; ``data`` numpy matrix builders; and
``convert`` numpy leaves to the port's states. Importing it needs no
GPU, ``nvcc`` or ``triton``: the kernels build at first CUDA use.
"""
from . import convert, core, data, kernels  # noqa: F401
from .core import ArgmaxResult, BIFSolver, BlockState, CoeffHistory, \
    Dense, Jacobi, JudgeResult, Masked, MatvecFn, QuadratureTrace, \
    QuadState, Shifted, SolveResult, SolverConfig, SparseBELL, SparseCOO, \
    TraceQuadResult, bell_from_dense, logdet_quad, sparse_from_dense, \
    stack_masks, stack_ops, trace_quad, tree_freeze  # noqa: F401
from .kernels import LAUNCHES  # noqa: F401
