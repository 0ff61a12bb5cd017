"""PyTorch/CUDA port of ``repro`` (Gauss quadrature for matrix inverse
forms), slice by slice; ``repro`` stays the reference it is held to.

``core`` holds the operators, Lanczos, the Alg. 5 recurrence, the
matrix-function and block-Krylov brackets, the Alg. 2 solver, the
stochastic trace and the paper's applications (DPP / k-DPP chains,
greedy MAP, double greedy, the incremental Cholesky factor);
``core.sharded`` the lanes split over the ranks of a lane mesh
(``launch.make_lane_mesh``, ``sharding.lane_plan``); ``kernels`` the
hand-written Hopper kernels K1-K7 with their plain PyTorch versions; ``serve`` the continuous-batching ``BIFEngine`` and the
KV-cache block rankers; ``obs`` metrics, spans, the driver-signature
registry and convergence health; ``data`` numpy matrix builders; and
``convert`` numpy leaves to the port's states. Importing it needs no
GPU, ``nvcc`` or ``triton``: the kernels build at first CUDA use.
"""
from . import convert, core, data, kernels, launch, obs, serve, \
    sharding  # noqa: F401
from .core import ArgmaxResult, BIFSolver, BlockState, ChainFactor, \
    ChainState, CoeffHistory, Dense, DGResult, GreedyMapResult, Jacobi, \
    JudgeResult, LogLikelihoodResult, Masked, MatvecFn, QuadratureTrace, \
    QuadState, ShardedBIFSolver, Shifted, SolveResult, SolverConfig, \
    SparseBELL, SparseCOO, TraceQuadResult, bell_from_dense, greedy_map, \
    judge_argmax_sharded, judge_batch_sharded, \
    judge_kdpp_swap_batch_sharded, lane_specs, log_likelihood, \
    logdet_quad, run_double_greedy, sample_dpp, sample_kdpp, shard_ops, \
    solve_batch_sharded, sparse_from_dense, stack_masks, stack_ops, \
    trace_quad, \
    tree_freeze  # noqa: F401
from .kernels import LAUNCHES  # noqa: F401
