"""PyTorch/CUDA port of ``repro`` (Gauss quadrature for matrix inverse
forms), slice by slice; ``repro`` stays the reference it is held to.

``core`` holds the operators, Lanczos, the Alg. 5 recurrence, the
matrix-function and block-Krylov brackets, the Alg. 2 solver, the
stochastic trace and the paper's applications (DPP / k-DPP chains,
greedy MAP, double greedy, the incremental Cholesky factor);
``kernels`` the hand-written Hopper kernels K1-K7 with their plain
PyTorch versions; ``data`` numpy matrix builders; and ``convert`` numpy
leaves to the port's states. Importing it needs no
GPU, ``nvcc`` or ``triton``: the kernels build at first CUDA use.
"""
from . import convert, core, data, kernels  # noqa: F401
from .core import ArgmaxResult, BIFSolver, BlockState, ChainFactor, \
    ChainState, CoeffHistory, Dense, DGResult, GreedyMapResult, Jacobi, \
    JudgeResult, LogLikelihoodResult, Masked, MatvecFn, QuadratureTrace, \
    QuadState, Shifted, SolveResult, SolverConfig, SparseBELL, SparseCOO, \
    TraceQuadResult, bell_from_dense, greedy_map, log_likelihood, \
    logdet_quad, run_double_greedy, sample_dpp, sample_kdpp, \
    sparse_from_dense, stack_masks, stack_ops, trace_quad, \
    tree_freeze  # noqa: F401
from .kernels import LAUNCHES  # noqa: F401
