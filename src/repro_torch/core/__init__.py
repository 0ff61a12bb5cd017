"""Paper core, PyTorch port: Gauss-type quadrature bounds for bilinear
forms ``u^T f(A) u``, driven by the retrospective solver (paper Alg. 2)::

    from repro_torch.core import BIFSolver, Dense, logdet_quad

    solver = BIFSolver.create(max_iters=64, rtol=1e-3, backend="fused")
    res = solver.solve_batch(Dense(a), us, lam_min=lmn, lam_max=lmx)
    ld = logdet_quad(op, 512, block_size=8, lam_min=lmn, lam_max=lmx)

Public names follow ``repro.core``: solver.{BIFSolver, SolverConfig,
SolveResult, JudgeResult, ArgmaxResult, QuadratureTrace, QuadState,
PairState},
matfun.{REGISTRY, SpectralFn, CoeffHistory}, block.{BlockState,
block_init, block_step}, trace.{trace_quad, logdet_quad,
TraceQuadResult, TraceQuadState}, operators.{Dense, SparseCOO,
SparseBELL, Masked, Shifted, Jacobi, MatvecFn, stack_ops, stack_masks,
bell_from_dense, sparse_from_dense, matvec_mrhs}, gql.{gql_init,
gql_step, GQLState}, spectrum.{lanczos_extremal, gershgorin_bounds,
ridge_bounds}, loop_utils.tree_freeze, bounds.{bif_bounds_trace,
BIFTrace, BIFBounds}, the applications dpp.{ChainState,
GreedyMapResult, LogLikelihoodResult, greedy_map, log_likelihood,
sample_dpp, sample_kdpp}, update.ChainFactor and
double_greedy.{DGResult, double_greedy as run_double_greedy}, and the
lanes over a mesh sharded.{ShardedBIFSolver, solve_batch_sharded,
judge_batch_sharded, judge_argmax_sharded, judge_kdpp_swap_batch_sharded}
with operators.{lane_specs, shard_ops}.
"""
from . import block, bounds, double_greedy, dpp, gql, lanczos, \
    loop_utils, matfun, operators, sharded, solver, spectrum, trace, \
    update  # noqa: F401

from .solver import ArgmaxResult, BIFSolver, JudgeResult, PairState, \
    QuadratureTrace, QuadState, SolveResult, SolverConfig  # noqa: F401
from .block import BlockState  # noqa: F401
from .loop_utils import tree_freeze  # noqa: F401
from .matfun import CoeffHistory, SpectralFn  # noqa: F401
from .trace import TraceQuadResult, TraceQuadState, logdet_quad, \
    trace_quad  # noqa: F401
from .operators import Dense, Jacobi, Masked, MatvecFn, Shifted, \
    SparseBELL, SparseCOO, bell_from_dense, lane_specs, shard_ops, \
    sparse_from_dense, stack_masks, stack_ops  # noqa: F401
from .sharded import ShardedBIFSolver, judge_argmax_sharded, \
    judge_batch_sharded, judge_kdpp_swap_batch_sharded, \
    solve_batch_sharded  # noqa: F401
from .spectrum import SpectrumBounds, gershgorin_bounds, \
    lanczos_extremal, ridge_bounds  # noqa: F401
from .bounds import BIFBounds, BIFTrace, bif_bounds_trace  # noqa: F401
from .dpp import ChainState, GreedyMapResult, LogLikelihoodResult, \
    greedy_map, log_likelihood, sample_dpp, sample_kdpp  # noqa: F401
from .update import ChainFactor  # noqa: F401
from .double_greedy import DGResult, \
    double_greedy as run_double_greedy  # noqa: F401
