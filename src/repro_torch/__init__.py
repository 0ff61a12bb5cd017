"""PyTorch/CUDA port of ``repro`` (Gauss quadrature for matrix inverse
forms), slice by slice; ``repro`` stays the reference it is held to.

``core`` holds the operators, Lanczos, the Alg. 5 recurrence, the
matrix-function and block-Krylov brackets, the Alg. 2 solver, the
stochastic trace and the paper's applications (DPP / k-DPP chains,
greedy MAP, double greedy, the incremental Cholesky factor);
``core.sharded`` the lanes split over the ranks of a lane mesh
(``launch.make_lane_mesh``, ``sharding.lane_plan``); ``kernels`` the
hand-written Hopper kernels K1-K7 with their plain PyTorch versions;
``serve`` the continuous-batching ``BIFEngine``, the KV-cache block
rankers and the LLM ``Engine`` (prefill and decode with KV caches);
``obs`` metrics, spans, the driver-signature registry and convergence
health; ``data`` numpy matrix builders, the synthetic token stream and
the DPP batch selector; the training path of the dense LM: ``configs``
(the ten architectures), ``models`` (the dense decoder as an
``nn.Module`` with the reference's functional entry points), ``optim``
(AdamW), ``checkpoint`` (the reference's on-disk layout), ``train`` (the
fault-tolerant loop and the GQL spectral monitor), ``launch.train`` /
``launch.steps``, and its serving path (``launch.serve``); ``tree`` the
reference's leaf order; and ``convert`` numpy leaves to the port's
states, parameters and KV caches. Importing it needs no GPU, ``nvcc`` or
``triton``: the kernels build at first CUDA use.
"""
from . import checkpoint, configs, convert, core, data, kernels, launch, \
    models, obs, optim, serve, sharding, train, tree  # noqa: F401
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
from .serve import Engine, Request, generate_trace_count  # noqa: F401
