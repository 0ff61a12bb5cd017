"""The retrospective-quadrature solver, paper Alg. 2 (counterpart of
``repro.core.solver``).

    solver = BIFSolver(SolverConfig(max_iters=64, rtol=1e-3))
    res = solver.solve(op, u, lam_min=lmn, lam_max=lmx)   # SolveResult
    res = solver.solve(op, u, decide=lambda lo, hi: t < lo)

The loop is a resumable state machine: ``init_state`` / ``step_n`` /
``resume`` / ``finalize`` operate on a :class:`QuadState`, and ``solve``
is ``finalize(resume(init_state(...)))``. Where the reference runs
``jax.lax.while_loop`` on the device, this port runs a host loop over
decision rounds: each round takes ``decide_every`` steps on the device
and then makes exactly one device-to-host read, ``needs_more.any()``,
to decide whether another round is needed. Lanes that are done are
frozen bit-exactly (``loop_utils.tree_freeze``).

The loop is traced from inside through ``repro_torch.obs``: spans
``solver.solve`` (one ``solve`` / ``solve_batch``), ``solver.init``,
``solver.round`` (a round's steps, its ``needs_more`` and its read),
``solver.read`` (the read; the one before the first round sits under
``solver.solve``) and ``solver.finalize``; counters ``solver.rounds``,
``solver.reads`` and ``solver.lane_steps`` (``decide_every`` times the
lane count a round: the lane-steps the device computes, frozen lanes
included). They are host-side only: no span synchronises the device, so
the read stays a round's one sync.

The solver computes on the device of the operator it is given, and
raises if the query lies on another device. ``backend='pallas'`` routes
the recurrence through kernel K1 and SparseBELL matvecs through K2;
``backend='fused'`` runs each iteration as one fused step, K3 (dense) or
K4 (blocked-ELL) (``kernels/lanczos_step.py``).

``fn`` picks the spectral function of ``u^T f(A) u`` (core/matfun.py):
'inv' is the Alg. 5 recurrence; any other f carries a per-lane
coefficient history (``QuadState.coeffs``) and brackets from one stacked
Jacobi-matrix ``eigh`` per decision round. ``block_size = b > 1`` runs
the block recurrence of core/block.py on (..., b, N) probe blocks,
bracketing ``tr B^T f(A) B`` per lane; its operator application is one
``matvec_mrhs`` per iteration (kernel K5 for SparseBELL on 'pallas').

``solve_batch_sharded`` / ``judge_batch_sharded`` / ``judge_argmax_sharded``
split the lanes over the ranks of a lane mesh (core/sharded.py).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple

import torch

from ..obs import metrics as _metrics
from ..obs.spans import span as _span
from . import block as _block
from . import gql as _gql
from . import matfun as _matfun
from . import operators as _ops
from . import spectrum as _spectrum
from .loop_utils import tree_freeze

Tensor = torch.Tensor

_SPECTRA = ("explicit", "gershgorin", "lanczos", "ridge")
_PRECONDITIONS = ("none", "jacobi")
_BACKENDS = ("reference", "pallas", "fused")
_FNS = tuple(_matfun.REGISTRY)

_ROUNDS = _metrics.counter("solver.rounds")
_READS = _metrics.counter("solver.reads")
_LANE_STEPS = _metrics.counter("solver.lane_steps")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Policy knobs for the retrospective driver; the reference's field
    names, values and validation, so one set of kwargs drives both
    packages."""
    max_iters: int = 64
    rtol: float = 1e-2
    atol: float = 0.0
    spectrum: str = "explicit"       # 'explicit'|'gershgorin'|'lanczos'|'ridge'
    precondition: str = "none"       # 'none'|'jacobi'
    reorth: bool = False
    backend: str = "reference"       # 'reference'|'pallas'|'fused'
    decide_every: int = 1            # decision-round cadence R (>= 1)
    spectrum_iters: int = 16         # Lanczos steps for spectrum estimation
    ridge: float = 0.0               # known ridge for spectrum='ridge'
    pallas_interpret: bool | None = None  # True raises on CUDA operands
    fn: str = "inv"                  # spectral function (matfun.REGISTRY):
    #                                  'inv' is the Alg. 5 recurrence;
    #                                  others bracket u^T f(A) u via the
    #                                  Jacobi-matrix eigensolve
    block_size: int = 1              # block-Krylov width b: b > 1 runs
    #                                  the block recurrence on (..., b, N)
    #                                  probe blocks, bracketing
    #                                  tr B^T f(A) B per lane; b = 1 is
    #                                  the scalar driver

    def __post_init__(self):
        if self.spectrum not in _SPECTRA:
            raise ValueError(f"spectrum must be one of {_SPECTRA}, "
                             f"got {self.spectrum!r}")
        if self.precondition not in _PRECONDITIONS:
            raise ValueError(f"precondition must be one of {_PRECONDITIONS}, "
                             f"got {self.precondition!r}")
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, "
                             f"got {self.backend!r}")
        if self.max_iters < 1:
            raise ValueError("max_iters must be >= 1")
        if self.decide_every < 1:
            raise ValueError(
                f"decide_every must be >= 1, got {self.decide_every}")
        _matfun.fn_index(self.fn)  # raises on unknown fn tags
        if self.fn != "inv" and self.precondition != "none":
            raise ValueError(
                "precondition='jacobi' is an identity for u^T A^-1 u only "
                "(u^T f(A) u has no similarity-transform counterpart); "
                "fn != 'inv' requires precondition='none'")
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}")
        if self.block_size > 1 and self.reorth:
            raise NotImplementedError(
                "reorthogonalization is not implemented for the block "
                "recurrence; block_size > 1 requires reorth=False")
        if self.block_size > 1 and self.precondition != "none":
            raise NotImplementedError(
                "preconditioning transforms each probe column "
                "separately and would break the block bracket's "
                "tr B^T f(A) B semantics; block_size > 1 requires "
                "precondition='none'")


class SolveResult(NamedTuple):
    """Rich per-lane outcome of one retrospective solve."""
    lower: Tensor          # best lower bound (right Gauss-Radau, Thm. 4)
    upper: Tensor          # best upper bound (left Gauss-Radau, Thm. 6)
    gauss_lower: Tensor    # plain Gauss lower bound (Thm. 2)
    lobatto_upper: Tensor  # Gauss-Lobatto upper bound
    iterations: Tensor     # int32 quadrature iterations spent per lane
    converged: Tensor      # resolved by bounds OR Krylov space exhausted
    certified: Tensor      # resolved by the bounds alone
    state: Any             # final QuadState (resume()-able checkpoint)


class JudgeResult(NamedTuple):
    decision: Tensor     # bool
    certified: Tensor    # bool, True if resolved by bounds
    iterations: Tensor   # int32 total quadrature iterations spent


class ArgmaxResult(NamedTuple):
    """Outcome of a certified argmax race over K candidate lanes."""
    index: Tensor        # int32 winning lane (last axis of the batch)
    certified: Tensor    # bool, winner's lower bound cleared every rival
    iterations: Tensor   # (..., K) int32 per-lane iterations spent
    lower: Tensor        # (..., K) final score lower bounds
    upper: Tensor        # (..., K) final score upper bounds


class QuadratureTrace(NamedTuple):
    gauss: Tensor        # (iters, ...) lower
    radau_lower: Tensor  # (iters, ...) right Gauss-Radau
    radau_upper: Tensor  # (iters, ...) left Gauss-Radau
    lobatto: Tensor      # (iters, ...) upper


class PairState(NamedTuple):
    a: Any  # GQLState for the first (u-side) system
    b: Any  # GQLState for the second (v-side) system


class QuadState(NamedTuple):
    """Checkpointable retrospective-solve state: the prepared operator,
    the recurrence state (``gql.GQLState``, or ``block.BlockState`` when
    ``block_size > 1``), the spectral interval, the reorth basis (or
    None), the global step counter (the basis write cursor), and the
    matfun coefficient history (``matfun.CoeffHistory``, or None on the
    fn='inv' path and on block states).

    Invariant: ``resume(step_n(state, k))`` is the same computation as
    ``resume(state)``."""
    op: Any
    st: Any           # gql.GQLState or block.BlockState
    lam_min: Tensor
    lam_max: Tensor
    basis: Any        # (..., M, N) reorth storage, or None
    step: Tensor      # int32, global steps taken since init
    coeffs: Any = None  # matfun.CoeffHistory, or None

    def bracket(self) -> tuple:
        """(lower, upper) in one pass: on matfun and block states both
        sides share one eigensolve, so prefer this over reading
        ``.lower`` and ``.upper`` separately."""
        lo, hi, _, _ = _bracket4(self.st, self.coeffs, self.lam_min,
                                 self.lam_max)
        return lo, hi

    @property
    def lower(self) -> Tensor:
        return self.bracket()[0]

    @property
    def upper(self) -> Tensor:
        return self.bracket()[1]

    @property
    def it(self) -> Tensor:
        return self.st.it

    @property
    def done(self) -> Tensor:
        return self.st.done


# The threading contract of QuadState's fields, as the reference states it
# (repro/core/solver.py): per-lane fields are frozen per lane by the step
# drivers, carried ones are threaded whole through every drive, prepared
# ones are resolved once by init_state. The three partition the fields.
QUADSTATE_PER_LANE = ("st", "basis", "coeffs")
QUADSTATE_CARRIED = ("step",)
QUADSTATE_PREPARED = ("op", "lam_min", "lam_max")


def _bracket4(st, coeffs, lam_min, lam_max):
    """(lower, upper, loose_lower, loose_upper): the tight Radau bracket
    and the loose Gauss/Lobatto pair, oriented per fn. The GQL views for
    fn='inv' (coeffs is None), the block trace bracket on block states,
    else the sign-aware matfun bracket."""
    if isinstance(st, _block.BlockState):
        return _block.bracket(st, lam_min, lam_max)
    if coeffs is None:
        return (_gql.lower_bound(st), _gql.upper_bound(st),
                _gql.lower_bound_gauss(st), _gql.upper_bound_lobatto(st))
    return _matfun.bracket(coeffs, st, lam_min, lam_max)


def _bracket2(st, coeffs, lam_min, lam_max):
    """The (lower, upper) bracket the stopping rules act on."""
    if isinstance(st, _block.BlockState) or coeffs is not None:
        return _bracket4(st, coeffs, lam_min, lam_max)[:2]
    return _gql.lower_bound(st), _gql.upper_bound(st)


def _argmax_scores(lo: Tensor, hi: Tensor, shift, scale, valid,
                   prior_upper=None, prior_lower=None):
    """Per-lane score brackets ``shift + scale * [lo, hi]`` for the argmax
    race, with invalid lanes pinned at a large negative sentinel.
    ``prior_upper``/``prior_lower`` clamp the bracket to externally-known
    valid bounds (never past the lane's own other side)."""
    big_neg = torch.tensor(-1e30, dtype=lo.dtype, device=lo.device)
    a = shift + scale * lo
    b = shift + scale * hi
    slo, shi = torch.minimum(a, b), torch.maximum(a, b)
    if prior_upper is not None:
        shi = torch.maximum(torch.minimum(shi, torch.as_tensor(
            prior_upper, dtype=shi.dtype, device=shi.device)), slo)
    if prior_lower is not None:
        slo = torch.minimum(torch.maximum(slo, torch.as_tensor(
            prior_lower, dtype=slo.dtype, device=slo.device)), shi)
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=lo.device)
        slo = torch.where(valid, slo, big_neg)
        shi = torch.where(valid, shi, big_neg)
    return slo, shi


def _argmax_race(slo: Tensor, shi: Tensor):
    """(dominated, winner) per lane of the certified argmax race."""
    k = shi.shape[-1]
    if k == 1:
        return (torch.zeros_like(shi, dtype=torch.bool),
                torch.ones_like(shi, dtype=torch.bool))
    best_lo = torch.amax(slo, dim=-1, keepdim=True)
    dominated = shi < best_lo
    order = torch.sort(shi, dim=-1).values
    top1, top2 = order[..., -1:], order[..., -2:-1]
    leader = torch.argmax(shi, dim=-1, keepdim=True)
    rival_hi = torch.where(torch.arange(k, device=shi.device) == leader,
                           top2, top1)
    winner = slo >= rival_hi
    return dominated, winner


def _first_argmax(x: Tensor) -> Tensor:
    """Index of the first maximum along the last axis. torch.argmax takes
    no bool tensor, so a bool mask is cast to int first."""
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return torch.argmax(x, dim=-1)


def _traced(name: str):
    """Run the decorated method inside a ``name`` span."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with _span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def _read(nm: Tensor) -> bool:
    """A host loop's device-to-host read, ``nm.any()``: a ``solver.read``
    span, counted in ``solver.reads``."""
    with _span("solver.read"):
        more = bool(nm.any())
    _READS.inc()
    return more


def _rounds(advance, carry: tuple, lane_steps: int, limit=None) -> tuple:
    """The host loop over decision rounds. ``carry[-1]`` is the lanes'
    needs-more mask; while its read finds a lane that needs more,
    ``carry = advance(carry)`` runs one round, which ends with the next
    mask, read inside the round's ``solver.round`` span. Each round adds 1
    to ``solver.rounds`` and ``lane_steps`` to ``solver.lane_steps``. The
    round that reaches ``limit`` rounds makes no read."""
    more, taken = _read(carry[-1]), 0
    while more:
        with _span("solver.round"):
            carry = advance(carry)
            taken += 1
            _ROUNDS.inc()
            _LANE_STEPS.inc(lane_steps)
            more = (limit is None or taken < limit) and _read(carry[-1])
    return carry


@dataclasses.dataclass(frozen=True)
class BIFSolver:
    """One retrospective quadrature driver; see the module docstring."""
    config: SolverConfig = SolverConfig()

    @classmethod
    def create(cls, **config_kwargs) -> "BIFSolver":
        return cls(SolverConfig(**config_kwargs))

    def replace(self, **config_kwargs) -> "BIFSolver":
        return BIFSolver(dataclasses.replace(self.config, **config_kwargs))

    # -- backend / problem preparation --------------------------------------

    def _stepper(self):
        """One-iteration GQL step per ``config.backend``:
        ``stepfn(op, st, lam_min, lam_max, basis, rows=None)``. 'fused'
        runs the whole iteration as one fused step (K3/K4), with K3's
        reorth reading only the ``rows`` live basis rows;
        'reference'/'pallas' compose ``gql.gql_step`` with the configured
        recurrence and ignore ``rows``. With
        ``block_size > 1`` every backend steps the block recurrence; the
        backend still picks the operator's matvec through
        ``configure_backend`` (K5 for SparseBELL on 'pallas')."""
        if self.config.block_size > 1:
            def block_step(op, st, lam_min, lam_max, basis=None, rows=None):
                return _block.block_step(op, st, lam_min, lam_max)

            return block_step
        if self.config.backend == "fused":
            from ..kernels.lanczos_step import gql_step_fused
            return gql_step_fused
        rec = self._recurrence()

        def composed_step(op, st, lam_min, lam_max, basis=None, rows=None):
            return _gql.gql_step(op, st, lam_min, lam_max, basis=basis,
                                 recurrence=rec)

        return composed_step

    def _recurrence(self):
        """Scalar-recurrence implementation per ``config.backend``."""
        if self.config.backend != "pallas":
            return None  # gql_step default: gql.recurrence_update
        from ..kernels import ops as _kops

        def pallas_recurrence(alpha_n, beta_n, beta_p, g, c, delta,
                              d_lr, d_rr, lam_min, lam_max):
            shape = g.shape

            def flat(x):
                # lanes as a flat view; a 0-d value (the interval) goes
                # as it is, and K1 reads it at stride 0
                x = torch.as_tensor(x, dtype=g.dtype, device=g.device)
                if x.ndim == 0:
                    return x
                return torch.broadcast_to(x, shape).reshape(-1)

            outs = _kops.gql_update(
                flat(alpha_n), flat(beta_n), flat(beta_p), g.reshape(-1),
                flat(c), flat(delta), flat(d_lr), flat(d_rr), flat(lam_min),
                flat(lam_max))
            return tuple(o.reshape(shape) for o in outs)

        return pallas_recurrence

    def prepare(self, op, u: Tensor, lam_min=None, lam_max=None, probe=None):
        """Apply preconditioning and resolve the spectral interval.

        Returns ``(op, u, lam_min, lam_max)`` ready for ``gql_init``.
        Explicitly passed ``lam_min``/``lam_max`` always win; missing ends
        are filled per ``config.spectrum``. With
        ``precondition='jacobi'`` an explicit interval must bound the
        spectrum of the transformed operator ``D^-1/2 A D^-1/2``.
        """
        cfg = self.config
        dev = _ops.op_device(op)
        if not isinstance(u, torch.Tensor) or u.device != dev:
            where = u.device if isinstance(u, torch.Tensor) else type(u)
            raise ValueError(f"the query u must be a tensor on the "
                             f"operator's device {dev}, got {where}")
        if cfg.pallas_interpret and dev.type == "cuda":
            raise ValueError("pallas_interpret=True with CUDA operands: "
                             "there is no interpret mode on the card")
        op = _ops.configure_backend(op, cfg.backend, cfg.pallas_interpret)
        if cfg.precondition == "jacobi":
            pop = _ops.Jacobi.create(op)
            u = pop.transform_vector(u)
            op = pop
        if lam_min is not None and lam_max is not None:
            return op, u, lam_min, lam_max

        if cfg.spectrum == "explicit":
            raise ValueError(
                "spectrum='explicit' requires lam_min and lam_max; pass "
                "them to solve()/judge_*() or pick an estimating spectrum "
                "mode ('gershgorin' | 'lanczos' | 'ridge')")
        if cfg.spectrum == "gershgorin":
            est = _spectrum.gershgorin_bounds_spd(op)
        else:
            if probe is None:
                probe = torch.where(u.abs() > 0, u, torch.ones_like(u))
            if cfg.spectrum == "ridge":
                est = _spectrum.ridge_bounds(op, cfg.ridge, probe,
                                             num_iters=cfg.spectrum_iters)
            else:  # 'lanczos'
                est = _spectrum.lanczos_extremal(
                    op, probe, num_iters=cfg.spectrum_iters)
        lam_min = est.lam_min if lam_min is None else lam_min
        lam_max = est.lam_max if lam_max is None else lam_max
        return op, u, lam_min, lam_max

    # -- the resumable runtime ------------------------------------------------

    def _needs_more_fn(self, decide, it_cap=None, *, lam_min=None,
                       lam_max=None):
        """(needs_more(st, coeffs), resolved(st, coeffs)): a lane keeps
        stepping while it is not done, not resolved by ``decide`` (None =
        the tolerance rule), and within ``max_iters``, its history
        buffer and the optional ``it_cap``. ``lam_min``/``lam_max`` feed
        the matfun and block brackets."""
        local_ok = self._local_ok_fn(it_cap)

        def resolved(st, coeffs):
            lo, hi = _bracket2(st, coeffs, lam_min, lam_max)
            if decide is None:
                return self.tolerance_resolved(lo, hi)
            return decide(lo, hi)

        def needs_more(st, coeffs):
            return local_ok(st, coeffs) & ~resolved(st, coeffs)

        return needs_more, resolved

    def _local_ok_fn(self, it_cap=None):
        """The decide-free per-lane continuation conditions, applied at
        every step even inside a ``decide_every`` round: not broken
        down, below ``max_iters``, within the coefficient (or block A/B)
        history, and below the optional ``it_cap``. An undersized history
        buffer freezes a lane like an iteration budget: its bracket stops
        tightening but stays sound."""
        max_iters = self.config.max_iters

        def local_ok(st, coeffs):
            ok = ~st.done & (st.it < max_iters)
            if coeffs is not None:
                ok = ok & (st.it < coeffs.alphas.shape[-1])
            elif isinstance(st, _block.BlockState):
                ok = ok & (st.it < st.a_hist.shape[-3])
            if it_cap is not None:
                ok = ok & (st.it < torch.as_tensor(it_cap,
                                                   device=st.it.device))
            return ok

        return local_ok

    def _advance(self, op, st, lam_min, lam_max, basis, coeffs, step,
                 stepfn):
        """One unconditional step + reorth-basis / coefficient-history
        bookkeeping (no freezing). The basis row index clamps to the last
        row, as the reference's ``dynamic_update_index_in_dim`` does.

        Before step ``step`` only basis rows ``0 .. min(step + 2, M) - 1``
        can be non-zero (rows 0 and 1 at init, row ``min(s + 2, M - 1)``
        after step s), so every stepper gets that count as a device tensor:
        the fused one hands it to K3, which reads the live rows only, with
        no host read; the others ignore it."""
        rows = None if basis is None else torch.clamp(
            step + 2, max=basis.shape[-2]).to(torch.int32)
        st1 = stepfn(op, st, lam_min, lam_max, basis, rows=rows)
        if coeffs is not None:
            coeffs = _matfun.update_coeffs(coeffs, st, st1)
        if basis is None:
            return st1, None, coeffs
        idx = torch.clamp(step + 2, max=basis.shape[-2] - 1)
        basis1 = basis.index_copy(-2, idx.reshape(1).long(),
                                  st1.lz.v.unsqueeze(-2))
        return st1, basis1, coeffs

    @_traced("solver.init")
    def init_state(self, op, u: Tensor, *, lam_min=None, lam_max=None,
                   probe=None, basis_rows: int | None = None,
                   coeff_rows: int | None = None) -> QuadState:
        """Prepare the problem and take iteration 1 (Alg. 5 init).
        ``basis_rows`` sizes the reorthogonalization storage when
        ``config.reorth`` (default ``max_iters + 1``); ``coeff_rows`` the
        alpha/beta history when ``config.fn != 'inv'`` (default
        ``max_iters``).

        With ``block_size = b > 1`` the query is a (..., b, N) probe
        block and ``coeff_rows`` sizes the block A/B history, in block
        iterations."""
        cfg = self.config
        rows = cfg.max_iters if coeff_rows is None else coeff_rows
        if cfg.block_size > 1:
            if u.ndim < 2 or u.shape[-2] != cfg.block_size:
                raise ValueError(
                    f"block_size={cfg.block_size} wants (..., b, N) "
                    f"row-stacked probe blocks with b={cfg.block_size}, "
                    f"got shape {tuple(u.shape)}")
        op, u, lam_min, lam_max = self.prepare(op, u, lam_min, lam_max,
                                               probe)
        dev = u.device
        lam_min = torch.as_tensor(lam_min, dtype=u.dtype, device=dev)
        lam_max = torch.as_tensor(lam_max, dtype=u.dtype, device=dev)
        step = torch.zeros((), dtype=torch.int32, device=dev)
        if cfg.block_size > 1:
            # estimating spectrum modes give per-probe bounds: take the
            # union interval over the lane's block slots
            if lam_min.ndim > u.ndim - 2:
                lam_min = torch.amin(lam_min, dim=-1)
            if lam_max.ndim > u.ndim - 2:
                lam_max = torch.amax(lam_max, dim=-1)
            st0 = _block.block_init(op, u, lam_min, lam_max, cfg.fn, rows)
            return QuadState(op=op, st=st0, lam_min=lam_min,
                             lam_max=lam_max, basis=None, step=step,
                             coeffs=None)
        st0 = _gql.gql_init(op, u, lam_min, lam_max)
        if cfg.reorth:
            rows_b = cfg.max_iters + 1 if basis_rows is None else basis_rows
            basis = self._alloc_basis(st0, u, rows_b)
        else:
            basis = None
        coeffs = _matfun.init_coeffs(st0, cfg.fn, rows) \
            if cfg.fn != "inv" else None
        return QuadState(op=op, st=st0, lam_min=lam_min, lam_max=lam_max,
                         basis=basis, step=step, coeffs=coeffs)

    def _round_body(self, op, lam_min, lam_max, stepfn, local_ok):
        """One ``decide_every`` round: R substeps with local-only freezing
        (breakdown / max_iters / history / it_cap apply at once; the
        stopping rule waits for the round boundary).
        ``round_fn((st, basis, coeffs, step, nm))`` returns the same
        tuple."""
        r = self.config.decide_every

        def round_fn(carry):
            st, basis, coeffs, step, nm = carry
            for _ in range(r):
                st1, basis1, coeffs1 = self._advance(
                    op, st, lam_min, lam_max, basis, coeffs, step, stepfn)
                frozen = ~nm
                st1 = tree_freeze(st1, st, frozen)
                basis1 = tree_freeze(basis1, basis, frozen)
                coeffs1 = tree_freeze(coeffs1, coeffs, frozen)
                nm = nm & local_ok(st1, coeffs1)
                st, basis, coeffs, step = st1, basis1, coeffs1, step + 1
            return st, basis, coeffs, step, nm

        return round_fn

    def _loop_parts(self, state: QuadState, decide, it_cap):
        """``_rounds``' first arguments ``(advance, carry, lane_steps)``:
        one round with the next mask, the carry ``(st, basis, coeffs,
        step, needs_more)`` of ``state``, and the lane-steps a round
        computes."""
        needs_more, _ = self._needs_more_fn(decide, it_cap,
                                            lam_min=state.lam_min,
                                            lam_max=state.lam_max)
        round_fn = self._round_body(state.op, state.lam_min, state.lam_max,
                                    self._stepper(),
                                    self._local_ok_fn(it_cap))

        def advance(carry):
            st, basis, coeffs, step, _ = round_fn(carry)
            return st, basis, coeffs, step, needs_more(st, coeffs)

        nm = needs_more(state.st, state.coeffs)
        carry = (state.st, state.basis, state.coeffs, state.step, nm)
        return advance, carry, self.config.decide_every * nm.numel()

    def step_n(self, state: QuadState, n: int, decide=None, *,
               it_cap=None, convergence_log=None) -> QuadState:
        """Advance ``state`` by at most ``n`` quadrature iterations, with
        the same freezing as ``resume``, so ``resume(step_n(state, k))``
        reproduces ``resume(state)``. With ``decide_every = R`` states stay
        round-aligned: at most ``floor(n / R) * R`` steps (``n < R`` is a
        no-op). One ``needs_more.any()`` host read per round; the bracket
        (an eigensolve on matfun and block states) is evaluated once per
        round.

        ``convergence_log`` (an :class:`repro_torch.obs.ConvergenceLog`)
        records the returned state's bracket and iteration counts, a host
        copy of the finished result, so logging is bit-invariant."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        rounds = n // self.config.decide_every
        if rounds == 0:
            return state
        st, basis, coeffs, step, _ = _rounds(
            *self._loop_parts(state, decide, it_cap), limit=rounds)
        out = state._replace(st=st, basis=basis, coeffs=coeffs, step=step)
        if convergence_log is not None:
            convergence_log.record_state(out)
        return out

    def resume(self, state: QuadState, decide=None, *,
               it_cap=None) -> QuadState:
        """Run the retrospective loop (Alg. 2) from ``state`` until
        ``decide`` resolves on every lane (or breakdown / ``max_iters`` /
        the history / ``it_cap``), freezing resolved lanes bit-exactly.
        One ``needs_more.any()`` host read per round of ``decide_every``
        steps."""
        st, basis, coeffs, step, _ = _rounds(
            *self._loop_parts(state, decide, it_cap))
        return state._replace(st=st, basis=basis, coeffs=coeffs, step=step)

    def resume_chunked(self, state: QuadState, decide=None, *,
                       chunk_iters: int, it_cap=None) -> QuadState:
        """``resume`` as repeated ``step_n(chunk_iters)`` rounds; the same
        steps and freezing as ``resume``. The chunk-boundary check
        evaluates the bracket once more per round than ``resume`` does
        (one extra eigensolve per round on matfun and block states)."""
        if chunk_iters < 1:
            raise ValueError(f"chunk_iters must be >= 1, got {chunk_iters}")
        r = self.config.decide_every
        chunk_iters = -(-chunk_iters // r) * r
        needs_more, _ = self._needs_more_fn(decide, it_cap,
                                            lam_min=state.lam_min,
                                            lam_max=state.lam_max)
        while _read(needs_more(state.st, state.coeffs)):
            state = self.step_n(state, chunk_iters, decide, it_cap=it_cap)
        return state

    @_traced("solver.finalize")
    def finalize(self, state: QuadState, decide=None) -> SolveResult:
        """Read a :class:`SolveResult` off a (partial or completed) state;
        ``certified`` re-evaluates ``decide`` on the banked bracket. For
        matfun and block states the fields are oriented per the registry's
        sign table: ``lower``/``upper`` the tight Radau bracket,
        ``gauss_lower``/``lobatto_upper`` the loose lower/upper pair."""
        lam_min, lam_max = state.lam_min, state.lam_max
        st = state.st
        lower, upper, loose_lo, loose_hi = _bracket4(st, state.coeffs,
                                                     lam_min, lam_max)
        certified = self.tolerance_resolved(lower, upper) if decide is None \
            else decide(lower, upper)
        return SolveResult(
            lower=lower, upper=upper,
            gauss_lower=loose_lo, lobatto_upper=loose_hi,
            iterations=st.it, converged=st.done | certified,
            certified=certified, state=state)

    def _alloc_basis(self, st0, u: Tensor, num_rows: int) -> Tensor:
        """Reorthogonalization storage: rows 0..num_rows-1 hold v_0..v_M."""
        basis = torch.zeros(u.shape[:-1] + (num_rows, u.shape[-1]),
                            dtype=u.dtype, device=u.device)
        basis[..., 0, :] = st0.lz.v_prev   # v_0
        basis[..., min(1, num_rows - 1), :] = st0.lz.v  # v_1
        return basis

    def tolerance_resolved(self, lower: Tensor, upper: Tensor) -> Tensor:
        """The ``decide=None`` stopping rule: bracket gap within
        ``atol``/``rtol`` of the lower bound."""
        return (upper - lower) <= torch.clamp(
            self.config.rtol * lower.abs(), min=self.config.atol)

    @staticmethod
    def threshold_decision(t, lower: Tensor, upper: Tensor) -> Tensor:
        """Alg. 4 decision from a bracket: certified when ``t`` clears
        [lower, upper); bracket-midpoint tie-break when it does not."""
        return torch.where(t < lower, True,
                           torch.where(t >= upper, False,
                                       t < 0.5 * (lower + upper)))

    def solve(self, op, u: Tensor,
              decide: Callable[[Tensor, Tensor], Tensor] | None = None, *,
              lam_min=None, lam_max=None, probe=None) -> SolveResult:
        """Retrospective solve for ``u^T A^-1 u``: iterate quadrature until
        ``decide(lower, upper)`` is True on every lane (or exhaustion);
        ``decide=None`` brackets to ``rtol``/``atol``."""
        cfg = self.config
        lanes = math.prod(u.shape[:-2 if cfg.block_size > 1 else -1])
        with _span("solver.solve", lanes=lanes, backend=cfg.backend,
                   decide_every=cfg.decide_every):
            state = self.init_state(op, u, lam_min=lam_min, lam_max=lam_max,
                                    probe=probe)
            state = self.resume(state, decide)
            return self.finalize(state, decide)

    def trace(self, op, u: Tensor, num_iters: int, *, lam_min=None,
              lam_max=None, probe=None,
              convergence_log=None) -> QuadratureTrace:
        """Run exactly ``num_iters`` iterations, recording all four
        estimate sequences (paper Fig. 1). For matfun states the fields
        are oriented per the sign table: ``radau_lower``/``radau_upper``
        the tight bracket, ``gauss``/``lobatto`` the loose lower/upper
        (the Lobatto/Gauss rules respectively for log-like f).

        ``convergence_log`` (an :class:`repro_torch.obs.ConvergenceLog`)
        records the returned Radau bracket per iteration, read off the
        finished trace on the host, bit-identical to the returned fields."""
        if num_iters < 1:
            raise ValueError(f"num_iters must be >= 1, got {num_iters}")
        state = self.init_state(op, u, lam_min=lam_min, lam_max=lam_max,
                                probe=probe, basis_rows=num_iters + 1,
                                coeff_rows=num_iters)
        stepfn = self._stepper()

        def estimates(st, coeffs):
            lo, hi, loose_lo, loose_hi = _bracket4(
                st, coeffs, state.lam_min, state.lam_max)
            return loose_lo, lo, hi, loose_hi

        seqs = [estimates(state.st, state.coeffs)]
        st, basis, coeffs, step = (state.st, state.basis, state.coeffs,
                                   state.step)
        for _ in range(num_iters - 1):
            st, basis, coeffs = self._advance(state.op, st, state.lam_min,
                                              state.lam_max, basis, coeffs,
                                              step, stepfn)
            step = step + 1
            seqs.append(estimates(st, coeffs))
        tr = QuadratureTrace(*(torch.stack(f) for f in zip(*seqs)))
        if convergence_log is not None:
            convergence_log.record_trace(tr)
        return tr

    # -- judges and the batched driver --------------------------------------

    def judge_threshold(self, op, u: Tensor, t, *, lam_min=None,
                        lam_max=None, probe=None) -> JudgeResult:
        """Alg. 4 (DPPJUDGE): True iff  t < u^T A^-1 u."""
        t = torch.as_tensor(t, dtype=u.dtype, device=u.device)
        res = self.solve(op, u, decide=lambda lo, hi: (t < lo) | (t >= hi),
                         lam_min=lam_min, lam_max=lam_max, probe=probe)
        decision = self.threshold_decision(t, res.lower, res.upper)
        return JudgeResult(decision=decision, certified=res.certified,
                           iterations=res.iterations)

    def solve_batch(self, op, u: Tensor,
                    decide: Callable[[Tensor, Tensor], Tensor] | None = None,
                    *, lam_min=None, lam_max=None, probe=None) -> SolveResult:
        """Retrospective solve over K candidate systems as lockstep lanes
        of ONE driver. ``u`` is (..., K, N); ``op`` is shared by every
        lane, lane-batched (``stack_ops``) or stacked masks
        (``stack_masks``). ``decide`` may reduce across lanes."""
        min_ndim = 3 if self.config.block_size > 1 else 2
        if u.ndim < min_ndim:
            if self.config.block_size > 1:
                raise ValueError(
                    f"solve_batch with block_size={self.config.block_size} "
                    f"wants (..., K, b, N) stacked probe blocks, got shape "
                    f"{tuple(u.shape)}; use solve() for a single block")
            raise ValueError(
                f"solve_batch wants (..., K, N) stacked queries, got shape "
                f"{tuple(u.shape)}; use solve() for a single system")
        return self.solve(op, u, decide, lam_min=lam_min, lam_max=lam_max,
                          probe=probe)

    def judge_batch(self, op, u: Tensor, t, *, lam_min=None, lam_max=None,
                    probe=None) -> JudgeResult:
        """K threshold judges (Alg. 4) in one batched driver:
        ``decision[k] = t[k] < u_k^T A_k^-1 u_k`` with per-lane early
        exit. ``t`` broadcasts against the (..., K) lane shape."""
        if u.ndim < 2:
            raise ValueError(
                f"judge_batch wants (..., K, N) stacked queries, got shape "
                f"{tuple(u.shape)}; use judge_threshold() for a single "
                f"system")
        return self.judge_threshold(op, u, t, lam_min=lam_min,
                                    lam_max=lam_max, probe=probe)

    def judge_argmax(self, op, u: Tensor, *, shift=None, scale=None,
                     valid=None, prior_upper=None, prior_lower=None,
                     lam_min=None, lam_max=None, probe=None) -> ArgmaxResult:
        """Certified argmax over K candidate scores
        ``shift_k + scale_k * u_k^T A_k^-1 u_k`` (greedy MAP's inner loop).
        Lanes freeze once dominated; the loop ends when the survivor's
        lower bound clears every rival's upper bound (or exhaustion, then
        bracket midpoints pick with ``certified=False``)."""
        if u.ndim < 2:
            raise ValueError(f"judge_argmax wants (..., K, N) stacked "
                             f"queries, got shape {tuple(u.shape)}")

        def as_t(x, default):
            return torch.as_tensor(default if x is None else x,
                                   dtype=u.dtype, device=u.device)

        shift = as_t(shift, 0.0)
        scale = as_t(scale, 1.0)

        def scores(lo, hi):
            return _argmax_scores(lo, hi, shift, scale, valid, prior_upper,
                                  prior_lower)

        def resolved(lo, hi):
            dominated, winner = _argmax_race(*scores(lo, hi))
            return dominated | winner

        res = self.solve_batch(op, u, decide=resolved, lam_min=lam_min,
                               lam_max=lam_max, probe=probe)
        slo, shi = scores(res.lower, res.upper)
        _, winner = _argmax_race(slo, shi)
        certified = torch.any(winner, dim=-1)
        mid = 0.5 * (slo + shi)
        index = torch.where(certified, _first_argmax(winner),
                            _first_argmax(mid)).to(torch.int32)
        return ArgmaxResult(index=index, certified=certified,
                            iterations=res.iterations, lower=slo, upper=shi)

    # -- lanes over a mesh (core/sharded.py, DESIGN.md Sec. 7) ---------------

    def solve_batch_sharded(self, op, u: Tensor, decide=None, *, mesh,
                            axis: str = "lanes", lam_min=None, lam_max=None,
                            probe=None, decide_args=()) -> SolveResult:
        """``solve_batch`` with the K lanes split over ``mesh``'s ranks;
        per-lane outcomes are those of the single-device driver."""
        from . import sharded as _sharded
        return _sharded.solve_batch_sharded(
            self, op, u, decide, mesh=mesh, axis=axis, lam_min=lam_min,
            lam_max=lam_max, probe=probe, decide_args=decide_args)

    def judge_batch_sharded(self, op, u: Tensor, t, *, mesh,
                            axis: str = "lanes", lam_min=None, lam_max=None,
                            probe=None) -> JudgeResult:
        """``judge_batch`` over a lane mesh."""
        from . import sharded as _sharded
        return _sharded.judge_batch_sharded(
            self, op, u, t, mesh=mesh, axis=axis, lam_min=lam_min,
            lam_max=lam_max, probe=probe)

    def judge_argmax_sharded(self, op, u: Tensor, *, mesh,
                             axis: str = "lanes", shift=None, scale=None,
                             valid=None, prior_upper=None, prior_lower=None,
                             lam_min=None, lam_max=None,
                             probe=None) -> ArgmaxResult:
        """``judge_argmax`` over a lane mesh: every rank races all lanes'
        brackets, gathered once a round."""
        from . import sharded as _sharded
        return _sharded.judge_argmax_sharded(
            self, op, u, mesh=mesh, axis=axis, shift=shift, scale=scale,
            valid=valid, prior_upper=prior_upper, prior_lower=prior_lower,
            lam_min=lam_min, lam_max=lam_max, probe=probe)

    # -- the two-system judges -----------------------------------------------

    def judge_kdpp_swap_batch(self, op, u: Tensor, v: Tensor, t, p, *,
                              lam_min=None, lam_max=None,
                              chunk_iters: int | None = None) -> JudgeResult:
        """Alg. 7 with both systems as two lanes of the batched driver:
        True iff ``t < p * v^T A^-1 v - u^T A^-1 u``, one stacked matvec
        per step. ``chunk_iters`` runs it in ``resume_chunked`` rounds."""
        if self.config.block_size > 1:
            raise NotImplementedError(
                "judge_kdpp_swap_batch stacks two scalar query systems; "
                "block_size > 1 brackets tr B^T f(A) B and has no swap-"
                "judge semantics — use block_size=1")
        uv = torch.stack([u, v], dim=-2)
        t = torch.as_tensor(t, dtype=u.dtype, device=u.device)
        p = torch.as_tensor(p, dtype=u.dtype, device=u.device)

        def bounds(lo, hi):
            return (p * lo[..., 1] - hi[..., 0],
                    p * hi[..., 1] - lo[..., 0])

        def resolved(lo, hi):
            blo, bhi = bounds(lo, hi)
            done = (t < blo) | (t >= bhi)
            return torch.broadcast_to(done[..., None], lo.shape)

        if chunk_iters is None:
            res = self.solve_batch(op, uv, decide=resolved, lam_min=lam_min,
                                   lam_max=lam_max)
        else:
            state = self.init_state(op, uv, lam_min=lam_min, lam_max=lam_max)
            state = self.resume_chunked(state, resolved,
                                        chunk_iters=chunk_iters)
            res = self.finalize(state, resolved)
        blo, bhi = bounds(res.lower, res.upper)
        return JudgeResult(decision=self.threshold_decision(t, blo, bhi),
                           certified=(t < blo) | (t >= bhi),
                           iterations=torch.sum(res.iterations, dim=-1,
                                                dtype=res.iterations.dtype))

    def judge_double_greedy_batch(self, op2, uv: Tensor, t, p, *,
                                  lam_min=None,
                                  lam_max=None) -> JudgeResult:
        """Alg. 9 with the X- and Y-side systems as two lanes of the
        batched driver: ``op2`` a 2-lane stacked operator
        (``stack_masks(base, [x_mask, y_mask])``), ``uv`` the (..., 2, N)
        queries. Same decision formulas as ``judge_double_greedy``."""
        if self.config.block_size > 1:
            raise NotImplementedError(
                "judge_double_greedy_batch stacks two scalar query "
                "systems; block_size > 1 brackets tr B^T f(A) B and has "
                "no gain-judge semantics — use block_size=1")
        t = torch.as_tensor(t, dtype=uv.dtype, device=uv.device)
        p = torch.as_tensor(p, dtype=uv.dtype, device=uv.device)

        def gain_bounds(lo, hi):
            gain = _matfun.log_gain_bounds
            lo_p, hi_p = gain(t, lo[..., 0], hi[..., 0])
            lo_log_y, hi_log_y = gain(t, lo[..., 1], hi[..., 1])
            return (torch.clamp(lo_p, min=0.0), torch.clamp(hi_p, min=0.0),
                    torch.clamp(-hi_log_y, min=0.0),
                    torch.clamp(-lo_log_y, min=0.0))

        def resolved(lo, hi):
            lo_p, hi_p, lo_m, hi_m = gain_bounds(lo, hi)
            safe = (p * hi_m <= (1 - p) * lo_p) | (p * lo_m > (1 - p) * hi_p)
            return torch.broadcast_to(safe[..., None], lo.shape)

        res = self.solve_batch(op2, uv, decide=resolved, lam_min=lam_min,
                               lam_max=lam_max)
        return self._double_greedy_decision(
            p, *gain_bounds(res.lower, res.upper),
            torch.sum(res.iterations, dim=-1, dtype=res.iterations.dtype))

    @staticmethod
    def _double_greedy_decision(p, lo_p, hi_p, lo_m, hi_m, iterations):
        add_safe = p * hi_m <= (1 - p) * lo_p
        rem_safe = p * lo_m > (1 - p) * hi_p
        mid = (p * 0.5 * (lo_m + hi_m)) <= ((1 - p) * 0.5 * (lo_p + hi_p))
        decision = torch.where(add_safe, True,
                               torch.where(rem_safe, False, mid))
        return JudgeResult(decision=decision, certified=add_safe | rem_safe,
                           iterations=iterations)

    def _prepare_pair(self, op_a, u, op_b, v, lam_min, lam_max):
        if self.config.block_size > 1:
            raise NotImplementedError(
                "the gap-weighted pair driver refines two scalar systems; "
                "block_size > 1 has no pair-judge semantics — use "
                "block_size=1")
        if self.config.fn != "inv":
            raise NotImplementedError(
                "the gap-weighted pair driver scores u^T A^-1 u only; "
                "matfun judges go through the batched driver "
                "(judge_kdpp_swap_batch / solve_batch with fn set)")
        if self.config.precondition != "none":
            raise NotImplementedError(
                "preconditioning is per-operator and would shift the two "
                "systems' quadrature scales differently; pair judges "
                "require precondition='none'")
        if self.config.reorth:
            raise NotImplementedError(
                "reorth is not implemented for the two-system driver; "
                "pair judges require reorth=False")
        if self.config.decide_every != 1:
            raise NotImplementedError(
                "the gap-weighted pair driver re-picks which side to "
                "refine from the bracket every iteration, so its decision "
                "rule cannot be deferred; pair judges require "
                "decide_every=1 (the batched kdpp/double-greedy judges "
                "support any cadence)")
        if lam_min is None or lam_max is None:
            _, _, lmn_a, lmx_a = self.prepare(op_a, u, lam_min, lam_max)
            _, _, lmn_b, lmx_b = self.prepare(op_b, v, lam_min, lam_max)

            def t_(x):
                return torch.as_tensor(x, dtype=u.dtype, device=u.device)

            lam_min = torch.minimum(t_(lmn_a), t_(lmn_b))
            lam_max = torch.maximum(t_(lmx_a), t_(lmx_b))
        return lam_min, lam_max

    def solve_pair(self, op_a, u: Tensor, op_b, v: Tensor, *,
                   resolved: Callable[[PairState], Tensor],
                   pick_a: Callable[[PairState], Tensor],
                   lam_min=None, lam_max=None) -> PairState:
        """Generic two-system retrospective loop (Alg. 7/9 skeleton): per
        step exactly one side of each lane advances, side a if
        ``pick_a(state)`` (and it can still move), else side b (the
        gap-weighted refinement of paper Sec. 5.1). Stops when
        ``resolved(state)`` everywhere or both sides are exhausted. One
        ``needs_more.any()`` host read per step."""
        lam_min, lam_max = self._prepare_pair(op_a, u, op_b, v, lam_min,
                                              lam_max)
        cfg = self.config
        max_iters = cfg.max_iters
        stepfn = self._stepper()
        op_a = _ops.configure_backend(op_a, cfg.backend, cfg.pallas_interpret)
        op_b = _ops.configure_backend(op_b, cfg.backend, cfg.pallas_interpret)
        st = PairState(a=_gql.gql_init(op_a, u, lam_min, lam_max),
                       b=_gql.gql_init(op_b, v, lam_min, lam_max))

        def exhausted(st):
            return (st.a.done | (st.a.it >= max_iters)) & \
                   (st.b.done | (st.b.it >= max_iters))

        def needs_more(st):
            return ~resolved(st) & ~exhausted(st)

        def advance(carry):
            st, nm = carry
            pick = pick_a(st)
            pick = (pick & ~st.a.done & (st.a.it < max_iters)) | \
                (st.b.done | (st.b.it >= max_iters))
            a1 = stepfn(op_a, st.a, lam_min, lam_max, None)
            b1 = stepfn(op_b, st.b, lam_min, lam_max, None)
            st = PairState(a=tree_freeze(a1, st.a, ~(nm & pick)),
                           b=tree_freeze(b1, st.b, ~(nm & ~pick)))
            return st, needs_more(st)

        nm = needs_more(st)
        # both systems of every lane step each round
        st, _ = _rounds(advance, (st, nm), 2 * nm.numel())
        return st

    def judge_kdpp_swap(self, op_a, u: Tensor, op_b, v: Tensor, t, p, *,
                        lam_min=None, lam_max=None) -> JudgeResult:
        """Alg. 7 (kDPP-JudgeGauss): True iff
        ``t < p * v^T B^-1 v - u^T A^-1 u``."""
        t = torch.as_tensor(t, dtype=u.dtype, device=u.device)
        p = torch.as_tensor(p, dtype=u.dtype, device=u.device)

        def bounds(st):
            # accept-safe: t < p*lower_v - upper_u;
            # reject-safe: t >= p*upper_v - lower_u
            lo = p * _gql.lower_bound(st.b) - _gql.upper_bound(st.a)
            hi = p * _gql.upper_bound(st.b) - _gql.lower_bound(st.a)
            return lo, hi

        def resolved(st):
            lo, hi = bounds(st)
            return (t < lo) | (t >= hi)

        st = self.solve_pair(
            op_a, u, op_b, v, resolved=resolved,
            pick_a=lambda st: _gql.gap(st.a) > p * _gql.gap(st.b),
            lam_min=lam_min, lam_max=lam_max)
        lo, hi = bounds(st)
        return JudgeResult(decision=self.threshold_decision(t, lo, hi),
                           certified=resolved(st),
                           iterations=st.a.it + st.b.it)

    def judge_double_greedy(self, op_x, u: Tensor, op_y, v: Tensor, t, p, *,
                            lam_min=None, lam_max=None) -> JudgeResult:
        """Alg. 9 (DG-JudgeGauss): True (add the element) iff
        ``p * [Delta^-]_+ <= (1 - p) * [Delta^+]_+`` with
        ``Delta^+ = log(t - u^T A_X^-1 u)`` and
        ``Delta^- = -log(t - v^T A_Y'^-1 v)`` (the paper's Sec. 2 signs,
        as the reference follows)."""
        t = torch.as_tensor(t, dtype=u.dtype, device=u.device)
        p = torch.as_tensor(p, dtype=u.dtype, device=u.device)

        def gain_bounds(st):
            gain = _matfun.log_gain_bounds
            lo_p, hi_p = gain(t, _gql.lower_bound(st.a),
                              _gql.upper_bound(st.a))
            lo_log_y, hi_log_y = gain(t, _gql.lower_bound(st.b),
                                      _gql.upper_bound(st.b))
            return (torch.clamp(lo_p, min=0.0), torch.clamp(hi_p, min=0.0),
                    torch.clamp(-hi_log_y, min=0.0),
                    torch.clamp(-lo_log_y, min=0.0))

        def resolved(st):
            lo_p, hi_p, lo_m, hi_m = gain_bounds(st)
            return (p * hi_m <= (1 - p) * lo_p) | (p * lo_m > (1 - p) * hi_p)

        def pick_a(st):
            lo_p, hi_p, lo_m, hi_m = gain_bounds(st)
            # tighten the Delta^+ side if its weighted gap dominates
            return (1 - p) * (hi_p - lo_p) >= p * (hi_m - lo_m)

        st = self.solve_pair(op_x, u, op_y, v, resolved=resolved,
                             pick_a=pick_a, lam_min=lam_min, lam_max=lam_max)
        return self._double_greedy_decision(p, *gain_bounds(st),
                                            st.a.it + st.b.it)
