"""The quadrature-serving engine, PyTorch port (counterpart of the
``BIFRequest`` / ``BIFEngine`` half of ``repro.serve.engine``; DESIGN.md
Sec. 8).

``BIFEngine`` is a continuous-batching scheduler over a fixed pool of
``max_batch`` quadrature lanes. Requests queue via ``submit``; ``flush``
admits them into free lanes, steps the whole pool in fixed-size chunks
through the resumable runtime (``BIFSolver.step_n``), retires lanes the
moment their decision resolves (or their iteration/deadline budget runs
out), and backfills the vacated lanes from the queue mid-flight.
Budget-interrupted requests come back as partial results carrying their
banked bracket and :class:`~repro_torch.core.solver.QuadState`;
resubmitting them resumes the solve bit-exactly where it stopped.

Where the reference jits its drivers, the port runs them as plain
functions; each reports a new driver signature (the keys a jit cache
would key on) to ``obs.registry`` once, so ``flush_trace_count`` keeps
its contract (see ``obs/registry.py``).

The pool lives on the operator's device (``operators.op_device``) in the
operator's dtype. The host bookkeeping (queries, masks, thresholds,
budgets, spectral-function indices) stays numpy and is uploaded with an
explicit ``device=`` once per admission round; a round's six per-lane
results come back in ONE ``.cpu()`` of a stacked tensor. Banked lane
states are clones, and admission scatters into new tensors, so a banked
request never shares storage with the pool; a resubmitted partial goes
back to the slot it was banked from when that slot is free
(``BIFEngine._place``), where it resumes bit-exactly on the card too.

With ``mesh=`` (a lane mesh, ``launch.make_lane_mesh``) the pool's lanes
split over the mesh's ranks (core/sharded.py). Every rank runs this same
host scheduler on the same requests: admission, ``_place``, retirement
and ``stats()`` counters agree on every rank, because every decision is
made from gathered values. Each rank uploads and steps only its own
slots; a round's per-lane results and the scheduler's clock are gathered
once, and a banked partial's lane state is broadcast from the rank that
holds it, so any rank can resume it in any slot.

Not ported yet: the LLM ``Engine`` / ``Request`` wait for the LLM
substrate.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from ..core import matfun as core_matfun
from ..core import operators as core_ops
from ..core import sharded as core_sharded
from ..core import spectrum as core_spectrum
from ..core.loop_utils import tree_freeze
from ..core.loop_utils import tree_map as _tree_map
from ..core.solver import BIFSolver, QuadState, _bracket2
from ..obs import metrics as obs_metrics
from ..obs import registry as _obs_registry
from ..obs import spans as obs_spans


@dataclasses.dataclass
class BIFRequest:
    """One bilinear-inverse-form query against the engine's matrix.

    ``t`` set: threshold judge (decision = t < u^T f(A) u, Alg. 4);
    ``t`` None: adaptive bracket to the solver's rtol/atol.
    ``fn``: spectral function tag (matfun registry; None = the engine
    solver's ``config.fn``). A matfun engine (solver ``fn != 'inv'``)
    serves mixed spectral functions per lane in one pool; a legacy
    f=1/x engine only takes 'inv'-tagged (or untagged) requests.
    ``mask``: optional principal-submatrix mask (the A_Y of a chain).
    ``max_iters``: per-submission quadrature-iteration budget (on top of
    the solver's ``max_iters`` ceiling); ``deadline``: wall-clock cutoff
    (a ``time.monotonic()`` instant, checked at admission, where an
    already-expired request retires with zero iterations, and at chunk
    boundaries). A request whose budget or deadline expires before its
    decision resolves comes back PARTIAL: ``resolved=False``, the banked
    bracket in ``lower``/``upper``, and the lane's quadrature state in
    ``state``; resubmit it (optionally with a new budget) to resume the
    solve bit-exactly where it stopped.

    ``u`` and ``mask`` are host arrays (numpy, or tensors, which are
    copied to the host at the door).
    """
    u: np.ndarray
    t: Optional[float] = None
    mask: Optional[np.ndarray] = None
    fn: Optional[str] = None
    max_iters: Optional[int] = None
    deadline: Optional[float] = None
    # filled by BIFEngine.flush():
    lower: Optional[float] = None
    upper: Optional[float] = None
    decision: Optional[bool] = None
    certified: Optional[bool] = None
    iterations: Optional[int] = None      # cumulative across resubmissions
    resolved: Optional[bool] = None       # decision/tolerance resolved OR
    #                                       Krylov-exhausted (bracket exact)
    state: Optional[Any] = None           # banked per-lane QuadState (partial)
    # set when a flush failed on this request's chunk (the request is
    # dropped from the queue; resubmit to retry a transient failure)
    error: Optional[Exception] = None


# One obs.registry key per flush driver (the lockstep _flush_run and the
# continuous pool's _pool_admit_run / _pool_scatter_run / _pool_step_run):
# each counts once per new driver signature, never on reuse.
_FLUSH_TRACE_KEYS = ("serve.engine.pool_admit", "serve.engine.pool_scatter",
                     "serve.engine.pool_step", "serve.engine.flush")

# QuadState threading contract: per-lane fields the continuous-batching
# pool does NOT merge/bank. `basis` (reorth storage) never reaches the
# scheduler (_flush_continuous falls back to the lockstep path for reorth
# configs), so admission and banking skip it (banked states carry
# basis=None).
ENGINE_ADMIT_EXCLUDED = ("basis",)

# The driver signatures met so far in this process, per driver.
_SIGNATURES = {k: set() for k in _FLUSH_TRACE_KEYS}
_SIG_LOCK = threading.Lock()


def flush_trace_count() -> int:
    """How many distinct BIFEngine flush-driver signatures this process
    has met (the reference counts compiles; see ``obs/registry.py``)."""
    return sum(_obs_registry.value(k) for k in _FLUSH_TRACE_KEYS)


def _signature(x):
    """What a jit cache keys on for one argument: the structure of nested
    states and operators, each tensor's shape, dtype and device, and the
    static values (ints, strings, configs) as they are."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, tuple):
        return (type(x).__name__,) + tuple(_signature(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _signature(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    return x


def _note_signature(name: str, *args) -> None:
    """Count ``name`` in obs.registry the first time these arguments'
    signature is met."""
    key = tuple(_signature(a) for a in args)
    with _SIG_LOCK:
        seen = _SIGNATURES[name]
        if key in seen:
            return
        seen.add(key)
    _obs_registry.count(name)


def _host(x) -> np.ndarray:
    """A request field as a host array (a tensor is copied off its
    device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _read_back(*values) -> np.ndarray:
    """Per-lane results of one round as ONE host copy: the values stacked
    as float64 rows (exact for the pool's floats, bools and int32
    counts) and moved with a single ``.cpu()``."""
    return torch.stack([v.to(torch.float64) for v in values]).cpu().numpy()


def _mixed_decide(solver, lo, hi, ts, has_t):
    """The engine's per-lane resolution rule: judge lanes resolve on
    their threshold, bracket lanes on the solver's tolerance rule."""
    thr = (ts < lo) | (ts >= hi)
    return torch.where(has_t, thr, solver.tolerance_resolved(lo, hi))


def _pool_admit_run(solver, op, st, coeffs, us, masks, fresh, fnidx,
                    lam_min, lam_max):
    """Seed the ``fresh`` lanes of the pool from (pre-masked) ``us`` /
    ``masks``; every other lane's quadrature state passes through
    unchanged (selected into new tensors). ``st=None`` initializes the
    whole pool (unoccupied lanes carry zero queries, which ``gql_init``
    marks done at iteration one). On a matfun pool ``fnidx`` is the
    authoritative per-lane spectral-function index and ``coeffs`` the
    prior pool coefficient history, frozen the same way."""
    _note_signature("serve.engine.pool_admit", solver.config, op, st,
                    coeffs, us, masks, fresh, fnidx, lam_min, lam_max)
    state = solver.init_state(core_ops.Masked(op, masks), us,
                              lam_min=lam_min, lam_max=lam_max)
    if st is not None:
        state = state._replace(st=tree_freeze(state.st, st, ~fresh))
        if coeffs is not None:
            state = state._replace(
                coeffs=tree_freeze(state.coeffs, coeffs, ~fresh))
    if state.coeffs is not None and fnidx is not None:
        state = state._replace(
            coeffs=dataclasses.replace(state.coeffs, fnidx=fnidx))
    return state


def _pool_scatter_run(st, lane_st, idx: int):
    """Insert one banked lane state (GQLState, and the lane's coeff
    history on matfun pools) at pool slot ``idx`` (warm admission of a
    resubmitted partial request). Functional, as the reference's
    ``.at[idx].set``: the pool's leaves are copied, never written in
    place, so no banked state shares storage with the pool."""
    _note_signature("serve.engine.pool_scatter", st, lane_st)

    def put(pool, lane):
        out = pool.clone()
        out[idx] = lane
        return out

    return _tree_map(put, st, lane_st)


def _lane(tree, i: int):
    """Lane ``i`` of a pool state, cloned out of the pool's storage."""
    return _tree_map(lambda leaf: leaf[i].clone(), tree)


def _share_lane(tree, i: int, mesh, axis: str):
    """Lane ``i`` (a global pool slot) of a rank-local pool state, on
    every rank: the rank that holds it packs its leaves into one f64
    vector (exact for the pool's floats, flags and int32 counts), which
    is broadcast and unpacked in each leaf's dtype and shape."""
    leaves = []
    kd = tree[0].it.shape[0]
    owner, j = divmod(i, kd)
    _tree_map(lambda leaf: leaves.append(leaf[j]) or leaf, tree)
    flat = core_sharded.broadcast_from(torch.cat(
        [x.reshape(-1).to(torch.float64) for x in leaves]), owner, mesh,
        axis)
    parts = iter(torch.split(flat, [x.numel() for x in leaves]))
    return _tree_map(lambda leaf: next(parts).reshape(leaf.shape[1:]).to(
        leaf.dtype), tree)


def _pool_step_run(solver, state, ts, has_t, it_cap, *, n, mesh=None,
                   axis: str = "lanes"):
    """One scheduler round: advance the pool by at most ``n`` quadrature
    iterations through the resumable runtime (``BIFSolver.step_n``, or
    ``step_n_sharded`` on the rank's slots when the engine is mesh-bound),
    freezing lanes the moment they resolve or exhaust their per-request
    ``it_cap`` budget. Returns the stepped state plus everything the host
    scheduler needs to retire lanes, over the whole pool (on a mesh, the
    per-lane values are gathered once)."""
    _note_signature("serve.engine.pool_step", solver.config, state, ts,
                    has_t, it_cap, n, mesh)
    if mesh is None:
        state = solver.step_n(
            state, n, lambda lo, hi: _mixed_decide(solver, lo, hi, ts,
                                                   has_t),
            it_cap=it_cap)
    else:
        state = core_sharded.step_n_sharded(
            solver, state, n,
            lambda lo, hi, ts_, ht_: _mixed_decide(solver, lo, hi, ts_,
                                                   ht_),
            decide_args=(ts, has_t), it_cap=it_cap, mesh=mesh, axis=axis)
    lo, hi = _bracket2(state.st, state.coeffs, state.lam_min,
                       state.lam_max)
    done, its = state.st.done, state.st.it
    if mesh is not None:
        lo, hi, done, its = core_sharded.gather_lanes(torch.stack(
            [lo.to(torch.float64), hi.to(torch.float64),
             done.to(torch.float64), its.to(torch.float64)], -1),
            mesh, axis).T.contiguous()
        lo, hi = lo.to(state.lam_min.dtype), hi.to(state.lam_min.dtype)
        done, its = done.to(torch.bool), its.to(torch.int32)
    resolved = _mixed_decide(solver, lo, hi, ts, has_t)
    decision = BIFSolver.threshold_decision(ts, lo, hi)
    return state, lo, hi, resolved, decision, done, its


def _flush_run(solver, op, us, masks, ts, has_t, lam_min, lam_max, *,
               mesh=None, axis: str = "lanes"):
    """ONE shared lockstep flush driver for every BIFEngine: a whole chunk
    as lanes of one ``solve_batch`` over the stacked masks
    (``solve_batch_sharded`` on a mesh)."""
    _note_signature("serve.engine.flush", solver.config, op, us, masks, ts,
                    has_t, lam_min, lam_max, mesh)
    mop = core_ops.Masked(op, masks)
    if mesh is None:
        res = solver.solve_batch(
            mop, us, decide=lambda lo, hi: _mixed_decide(solver, lo, hi,
                                                         ts, has_t),
            lam_min=lam_min, lam_max=lam_max)
    else:
        res = core_sharded.solve_batch_sharded(
            solver, mop, us,
            lambda lo, hi, ts_, ht_: _mixed_decide(solver, lo, hi, ts_, ht_),
            decide_args=(ts, has_t), mesh=mesh, axis=axis, lam_min=lam_min,
            lam_max=lam_max)
    decision = BIFSolver.threshold_decision(ts, res.lower, res.upper)
    return (res.lower, res.upper, decision,
            _mixed_decide(solver, res.lower, res.upper, ts, has_t),
            res.iterations, res.converged)


class BIFEngine:
    """Continuous-batching scheduler for BIF requests (DESIGN.md Sec. 8).

    Requests accumulate via ``submit``; ``flush`` serves them through a
    fixed pool of ``max_batch`` quadrature lanes. Each scheduler round
    admits queued requests into free lanes (FIFO), steps the WHOLE pool
    by ``chunk_iters`` quadrature iterations (aligned up to a whole
    number of ``decide_every`` rounds) through the resumable runtime
    (one stacked matvec per iteration; resolved lanes frozen
    bit-exactly), then retires every lane whose decision resolved, or
    whose per-request iteration/deadline budget ran out, and backfills
    the vacated lanes from the queue mid-flight. ``flush(mode=
    'lockstep')`` keeps the pad-to-``max_batch`` chunks for comparison.
    Completion is FIFO-preserving: ``flush`` returns requests in
    submission order regardless of retirement order.

    Mixed traffic is fine: judge lanes resolve on their threshold,
    bracket lanes on tolerance. Unoccupied lanes (zero query) resolve at
    iteration one and cost only their share of the stacked matvec.

    The pool lives on the operator's device, in the dtype of its
    diagonal. With ``mesh`` set (a 1-D lane mesh from
    ``launch.make_lane_mesh``) ``max_batch`` is rounded up to a multiple
    of the ranks and the pool's slots split over them; every rank must
    submit the same requests and flush together (see the module
    docstring).
    """

    def __init__(self, op, *, solver: BIFSolver | None = None,
                 max_batch: int = 64, lam_min: float | None = None,
                 lam_max: float | None = None, mesh=None,
                 lane_axis: str = "lanes", chunk_iters: int = 8,
                 metrics: bool = True, convergence_log=None):
        self.mesh, self.lane_axis = mesh, lane_axis
        max_batch = int(max_batch)
        self._mine = slice(None)     # this rank's pool slots
        if mesh is not None:
            from ..launch.mesh import lane_rank
            ndev, rank = lane_rank(mesh, lane_axis)
            max_batch = -(-max_batch // ndev) * ndev
            kd = max_batch // ndev
            self._mine = slice(rank * kd, (rank + 1) * kd)
        self.op = op
        self.solver = solver if solver is not None \
            else BIFSolver.create(max_iters=64, rtol=1e-3)
        if self.solver.config.block_size > 1:
            raise NotImplementedError(
                "the serving engine batches scalar (u, mask) queries; "
                "block_size > 1 brackets tr B^T f(A) B probe blocks and "
                "has no per-request semantics — use a block_size=1 "
                "solver (block traces go through trace_quad)")
        # step_n quantises to whole decide_every rounds: align the
        # serving chunk UP to the cadence so every flush makes progress
        # (a chunk smaller than one round would be a no-op and livelock
        # the pool)
        r = self.solver.config.decide_every
        self.chunk_iters = -(-max(1, int(chunk_iters)) // r) * r
        self.max_batch = max_batch
        if lam_min is None or lam_max is None:
            # one-time certified interval, valid for every request mask
            # by interlacing (DESIGN.md Sec. 3.2)
            est = core_spectrum.gershgorin_bounds_spd(op)
            if lam_min is None:
                lam_min = float(est.lam_min)
            if lam_max is None:
                lam_max = float(est.lam_max)
        self.lam_min, self.lam_max = float(lam_min), float(lam_max)
        self._queue: List[BIFRequest] = []
        self._device = core_ops.op_device(op)
        self._tdtype = self.op.diag().dtype
        self._dtype = _numpy_dtype(self._tdtype)
        # Observability (DESIGN.md Sec. 14): per-engine metric registry,
        # written HOST-SIDE only, from values the scheduler already copied
        # to the host, so metrics on/off cannot perturb a single device
        # computation (pinned by tests/test_torch_obs.py). A
        # `convergence_log` (obs.health.ConvergenceLog) records per-round
        # per-lane brackets off the same host copies.
        self._metrics_on = bool(metrics)
        self._metrics = obs_metrics.MetricsRegistry()
        self.convergence_log = convergence_log

        def run(us, masks, ts, has_t):
            return _flush_run(
                self.solver, self.op, us, masks, ts, has_t,
                self._scalar(self.lam_min), self._scalar(self.lam_max),
                mesh=self.mesh, axis=self.lane_axis)

        self._run = run

    def _scalar(self, x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=self._tdtype, device=self._device)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """A host array as a NEW tensor on the pool's device (a copy even
        on the CPU, so later host writes never reach the pool)."""
        return torch.tensor(x, device=self._device)

    def _now(self) -> float:
        """The scheduler's clock: ``time.monotonic()``, on a mesh the
        latest of the ranks' readings (one gather), so that every rank
        retires on the same deadlines."""
        now = time.monotonic()
        if self.mesh is None:
            return now
        return core_sharded.agree_clock(now, self.mesh, self.lane_axis)

    def submit(self, req: BIFRequest) -> BIFRequest:
        """Queue one request. Shapes are validated here so a malformed
        request is rejected at the door instead of poisoning a flush."""
        n = self.op.n
        u = _host(req.u)
        if u.shape != (n,):
            raise ValueError(
                f"BIFRequest.u must have shape ({n},), got {u.shape}")
        if req.mask is not None and _host(req.mask).shape != (n,):
            raise ValueError(
                f"BIFRequest.mask must have shape ({n},), got "
                f"{_host(req.mask).shape}")
        cfg_fn = self.solver.config.fn
        fn = cfg_fn if req.fn is None else req.fn
        core_matfun.fn_index(fn)  # raises on unknown tags
        if cfg_fn == "inv" and fn != "inv":
            raise ValueError(
                f"this engine's solver runs the legacy f=1/x recurrence; "
                f"fn={fn!r} requests need an engine built with a matfun "
                f"solver (BIFSolver.create(fn=...), any registry fn — "
                f"mixed-fn pools are fine there)")
        if req.state is not None:
            # a banked state continues the ORIGINAL (u, mask) query: the
            # Lanczos recurrence is only valid for the system it was
            # started on. A mutated query must re-solve from scratch.
            mask = np.ones((n,), self._dtype) if req.mask is None \
                else _host(req.mask).astype(self._dtype)
            banked = getattr(req, "_banked_query", None)
            if banked is None \
                    or not np.array_equal(u.astype(self._dtype) * mask,
                                          banked) \
                    or not np.array_equal(
                        mask, _host(req.state.op.mask).astype(self._dtype)):
                raise ValueError(
                    "BIFRequest.state banks the solve of the originally "
                    "submitted (u, mask); changing either invalidates "
                    "the banked recurrence — set state=None to re-solve "
                    "the new query from scratch")
            banked_fn = "inv" if req.state.coeffs is None else \
                core_matfun.fn_name(int(req.state.coeffs.fnidx))
            if banked_fn != fn:
                raise ValueError(
                    f"BIFRequest.state banks a fn={banked_fn!r} solve; "
                    f"resubmitting it as fn={fn!r} would misread the "
                    f"banked history — set state=None to re-solve")
            if (req.state.coeffs is None) != (cfg_fn == "inv"):
                # a matfun pool scatters CoeffHistory lanes, a legacy
                # pool coeff-free ones; a presence mismatch would blow
                # up mid-flush and poison the in-flight requests
                raise ValueError(
                    "BIFRequest.state was banked by a "
                    f"{'legacy f=1/x' if req.state.coeffs is None else 'matfun'} "
                    f"engine pool and cannot resume on this one "
                    f"(solver fn={cfg_fn!r}) — set state=None to re-solve")
        if req.t is not None:
            try:
                req.t = float(req.t)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"BIFRequest.t must be a scalar, got {req.t!r}") from e
        # Clear EVERY stale result field, not just the error: a request
        # resubmitted for refinement must not let a failed flush leave
        # the previous round's lower/upper/decision readable as if they
        # were current. The banked state/query stay: they are what a
        # resubmission resumes from (cumulative iteration counts live in
        # state.it and are restored at retirement).
        req.lower = req.upper = None
        req.decision = None
        req.certified = None
        req.iterations = None
        req.resolved = None
        req.error = None
        self._queue.append(req)
        req._obs_submit_t = time.monotonic()
        self._count("requests.submitted")
        if req.state is not None:
            self._count("requests.resubmitted")
        return req

    def pending(self) -> int:
        return len(self._queue)

    # -- observability (host-side only; see DESIGN.md Sec. 14) ------------

    def _count(self, name: str, n: int = 1) -> None:
        if self._metrics_on:
            self._metrics.counter(name).inc(n)

    def _observe(self, name: str, value: float) -> None:
        if self._metrics_on:
            self._metrics.histogram(name).observe(value)

    def _retire_obs(self, r: BIFRequest, now: float, *,
                    expired: bool = False) -> None:
        """Record one retirement. `now` is the scheduler's own clock
        read for this round, reused and never re-read, so the metrics see
        exactly the instants the scheduling decisions saw."""
        if not self._metrics_on:
            return
        self._count("requests.retired")
        sub_t = getattr(r, "_obs_submit_t", None)
        adm_t = getattr(r, "_obs_admit_t", None)
        if adm_t is not None:
            self._observe("request.latency_s", now - adm_t)
        elif sub_t is not None:
            # expired at the door: never admitted, queue-wait only
            self._observe("request.queue_wait_s", now - sub_t)
        if r.deadline is not None:
            self._observe("request.deadline_slack_s", r.deadline - now)
        if r.iterations is not None:
            self._observe("request.iterations", float(r.iterations))
        if r.resolved:
            self._count("requests.resolved")
        else:
            self._count("requests.partial")
            if expired:
                self._count("requests.expired")

    def stats(self) -> dict:
        """Plain-dict snapshot of this engine's request metrics:
        ``{"counters": {...}, "gauges": {...}, "histograms": {name:
        {count, sum, min, max, mean, p50, p90, p99, buckets}}}``:
        queue-wait / admission-to-retire latency / deadline-slack /
        iteration histograms, submitted / resolved / partial / expired /
        errored / resubmitted counters, per-round pool occupancy."""
        return self._metrics.snapshot()

    def reset_stats(self) -> None:
        self._metrics.reset()

    def _step(self, state, ts, has_t, it_cap):
        """One pool decision round (seam for tests / fault injection)."""
        return _pool_step_run(self.solver, state, ts, has_t, it_cap,
                              n=self.chunk_iters, mesh=self.mesh,
                              axis=self.lane_axis)

    def flush(self, *, mode: str = "continuous") -> List[BIFRequest]:
        """Serve every queued request; returns them in submission order
        (retirement order never reorders the returned list).
        Budget/deadline-interrupted requests come back partial
        (``resolved=False``) with their banked bracket + state.

        ``mode='lockstep'`` keeps the padded chunk flushes (no backfill,
        budgets and deadlines ignored), the benchmark baseline. Solver
        configs the scheduler does not take (reorth, preconditioning)
        fall back to it automatically.

        If the driver fails, the in-flight requests get their ``error``
        set and are dropped (resubmit to retry), the unadmitted tail
        stays queued in order, and the exception propagates; requests
        that already retired keep their results.
        """
        if mode not in ("continuous", "lockstep"):
            raise ValueError(f"mode must be 'continuous' or 'lockstep', "
                             f"got {mode!r}")
        self._count("flush.count")
        with obs_spans.span("engine.flush", mode=mode,
                            queued=len(self._queue)):
            if mode == "continuous":
                return self._flush_continuous()
            return self._flush_lockstep()

    # -- the continuous-batching scheduler --------------------------------

    def _flush_continuous(self) -> List[BIFRequest]:
        cfg = self.solver.config
        if cfg.reorth or cfg.precondition != "none":
            # the stepping scheduler banks/merges plain lane states;
            # reorth bases and preconditioned transforms keep the
            # lockstep path (per-request budgets/deadlines don't apply
            # there)
            return self._flush_lockstep()
        queue, self._queue = self._queue, []
        if not queue:
            return queue
        solver = self.solver
        n, p = self.op.n, self.max_batch
        dt = self._dtype
        max_iters = cfg.max_iters
        tracking = cfg.fn != "inv"          # matfun pool (per-lane fns)

        # host-side pool bookkeeping; device-side state in `state`
        us = np.zeros((p, n), dt)
        masks = np.ones((p, n), dt)
        ts = np.zeros((p,), dt)
        has_t = np.zeros((p,), bool)
        caps = np.zeros((p,), np.int32)   # 0 = vacated/dead lane (frozen)
        fnidx = np.full((p,), core_matfun.fn_index(cfg.fn), np.int32)
        slots: List[Optional[BIFRequest]] = [None] * p
        pending = list(queue)
        state = None
        lam_min = self._scalar(self.lam_min)
        lam_max = self._scalar(self.lam_max)
        # this rank's slots (the whole pool on one device); on a mesh the
        # clock of a round's admission is the one its last retirement
        # agreed on
        mine = self._mine
        local = range(p)[mine]
        clock = None

        try:
            while pending or any(r is not None for r in slots):
                # --- admit: backfill free lanes from the queue (FIFO) ---
                fresh = np.zeros((p,), bool)
                warm = []
                dirty = state is None
                now = clock if self.mesh is not None and clock is not None \
                    else self._now()
                free = [i for i in range(p) if slots[i] is None]
                admitted = []
                while pending and len(admitted) < len(free):
                    cand = pending.pop(0)
                    if cand.deadline is not None and now >= cand.deadline:
                        # already expired at the door: retire with ZERO
                        # pool rounds burned (no lane, no banked state,
                        # results stay cleared); FIFO order holds because
                        # the queue list itself is returned in submission
                        # order
                        cand.certified = False
                        cand.resolved = False
                        cand.iterations = 0
                        cand.state = None
                        self._retire_obs(cand, now, expired=True)
                        continue
                    admitted.append(cand)
                for i, r in self._place(admitted, free):
                    slots[i] = r
                    r._obs_admit_t = now
                    self._observe("request.queue_wait_s",
                                  now - getattr(r, "_obs_submit_t", now))
                    m = np.ones((n,), dt) if r.mask is None \
                        else _host(r.mask).astype(dt)
                    masks[i] = m
                    # restrict the query to the mask: Masked is only the
                    # true submatrix system for u supported on it (Sec. 3.2)
                    us[i] = _host(r.u).astype(dt) * m
                    ts[i] = 0.0 if r.t is None else r.t
                    has_t[i] = r.t is not None
                    fnidx[i] = core_matfun.fn_index(
                        cfg.fn if r.fn is None else r.fn)
                    budget = max_iters if r.max_iters is None \
                        else max(int(r.max_iters), 0)
                    if r.state is not None:
                        # warm admission: resume the banked state
                        warm.append((i, (r.state.st, r.state.coeffs)))
                        caps[i] = min(int(r.state.it) + budget, max_iters)
                    else:
                        fresh[i] = True
                        caps[i] = min(budget, max_iters)
                    dirty = True
                if all(r is None for r in slots):
                    # every queued request expired at admission: there
                    # is nothing to step
                    break
                if dirty:
                    if state is None or fresh[mine].any():
                        # fresh lanes seed from a POOL-SHAPED init on
                        # purpose (the rank's slots on a mesh): per-lane
                        # inits would change the matvec shape, and
                        # gemv-vs-gemm rounding can flip marginal
                        # iteration counts against the lockstep baseline
                        # (the Sec. 6.1 caveat)
                        state = _pool_admit_run(
                            solver, self.op,
                            None if state is None else state.st,
                            None if state is None else state.coeffs,
                            self._upload(us[mine]), self._upload(masks[mine]),
                            self._upload(fresh[mine]),
                            self._upload(fnidx[mine]) if tracking else None,
                            lam_min, lam_max)
                    else:
                        # warm-only round (for this rank): every admitted
                        # lane scatters a banked state in, so skip the
                        # pool init matvec and just rebind the masks on
                        # the pool operator
                        state = state._replace(op=dataclasses.replace(
                            state.op, mask=self._upload(masks[mine])))
                    for i, lane_sc in warm:
                        if i not in local:
                            continue        # another rank's slot
                        st_new, coeffs_new = _pool_scatter_run(
                            (state.st, state.coeffs), lane_sc,
                            i - local.start)
                        state = state._replace(st=st_new,
                                               coeffs=coeffs_new)

                # --- one decision round over the whole pool ---
                occupied = sum(1 for s in slots if s is not None)
                self._count("flush.rounds")
                self._observe("pool.occupancy", occupied / p)
                with obs_spans.span("engine.pool_step",
                                    occupied=occupied) as sp:
                    state, lo, hi, res, dec, done, its = self._step(
                        state, self._upload(ts), self._upload(has_t),
                        self._upload(caps))
                    # charge the device work to THIS span, not to the
                    # read-back below
                    sp.block_until_ready((lo, hi, res, dec, done, its))
                lo_h, hi_h, res_h, dec_h, done_h, it_h = _read_back(
                    lo, hi, res, dec, done, its)
                now = clock = self._now()
                if self.convergence_log is not None:
                    # host-side copies the retire loop reads anyway:
                    # logging cannot perturb the round
                    self.convergence_log.record(lo_h, hi_h, it_h)

                # --- retire: resolved lanes + expired budgets/deadlines ---
                for i in range(p):
                    r = slots[i]
                    if r is None:
                        continue
                    resolved = bool(res_h[i]) or bool(done_h[i])
                    capped = int(it_h[i]) >= min(int(caps[i]), max_iters)
                    timed_out = r.deadline is not None and now >= r.deadline
                    if not (resolved or capped or timed_out):
                        continue
                    r.lower, r.upper = float(lo_h[i]), float(hi_h[i])
                    r.decision = bool(dec_h[i]) if r.t is not None else None
                    r.certified = bool(res_h[i])
                    r.resolved = resolved
                    r.iterations = int(it_h[i])
                    if not resolved and int(it_h[i]) < max_iters:
                        # interrupted with headroom left: bank a per-lane
                        # QuadState (clones, never views of the pool; on
                        # a mesh every rank receives the lane from the
                        # rank that holds it) so resubmission resumes
                        # bit-exactly, plus the premasked query, so
                        # submit() can reject a mutated u/mask at the door
                        if self.mesh is None:
                            lane_st = _lane(state.st, i)
                            lane_coeffs = _lane(state.coeffs, i)
                        else:
                            lane_st, lane_coeffs = _share_lane(
                                (state.st, state.coeffs), i, self.mesh,
                                self.lane_axis)
                        r.state = QuadState(
                            op=dataclasses.replace(
                                state.op, mask=self._upload(masks[i])),
                            st=lane_st,
                            lam_min=state.lam_min, lam_max=state.lam_max,
                            basis=None, step=state.step,
                            coeffs=lane_coeffs)
                        r._banked_query = us[i].copy()
                        r._banked_slot = i
                    else:
                        r.state = None
                    self._retire_obs(r, now,
                                     expired=timed_out and not resolved)
                    slots[i] = None
                    caps[i] = 0  # freeze the vacated lane until backfill
        except Exception as e:
            # In-flight requests carry the error and are dropped (a
            # poison request must not wedge everything behind it); the
            # unadmitted tail stays queued IN ORDER; already-retired
            # requests keep their results.
            for r in slots:
                if r is not None:
                    r.error = e
                    self._count("requests.errored")
            self._queue = pending + self._queue
            raise
        return queue

    @staticmethod
    def _place(admitted, free):
        """Slots for this round's admitted requests (FIFO order kept): a
        resubmitted partial goes back to the slot it was banked from when
        that slot is free, the rest fill the free slots in order. On the
        card a lane's bits depend on its slot in the pool, so only a
        partial resumed in its own slot repeats an uninterrupted solve in
        that slot bit for bit."""
        open_ = set(free)
        placed = {}
        for r in admitted:
            home = getattr(r, "_banked_slot", None)
            if r.state is not None and home in open_:
                placed[home] = r
                open_.discard(home)
        rest = iter(r for r in admitted
                    if not any(r is q for q in placed.values()))
        for i in free:
            if i in open_:
                r = next(rest, None)
                if r is None:
                    break
                placed[i] = r
        return sorted(placed.items())

    # -- the lockstep flush (benchmark baseline) ---------------------------

    def _flush_lockstep(self) -> List[BIFRequest]:
        cfg_fn = self.solver.config.fn
        for r in self._queue:
            if r.fn is not None and r.fn != cfg_fn:
                # lockstep chunks run ONE solve_batch under the solver's
                # fn; per-lane mixing is a continuous-pool feature
                raise ValueError(
                    f"flush(mode='lockstep') serves the solver's "
                    f"fn={cfg_fn!r} only (got a fn={r.fn!r} request); "
                    f"mixed-fn traffic needs mode='continuous'")
        queue, self._queue = self._queue, []
        n, b = self.op.n, self.max_batch
        for start in range(0, len(queue), b):
            chunk = queue[start:start + b]
            now = time.monotonic()
            self._count("flush.rounds")
            self._observe("pool.occupancy", len(chunk) / b)
            for r in chunk:
                r._obs_admit_t = now
                self._observe("request.queue_wait_s",
                              now - getattr(r, "_obs_submit_t", now))
            try:
                us = np.zeros((b, n), self._dtype)
                masks = np.ones((b, n), self._dtype)
                ts = np.zeros((b,), self._dtype)
                has_t = np.zeros((b,), bool)
                for i, r in enumerate(chunk):
                    if r.mask is not None:
                        masks[i] = _host(r.mask)
                    # restrict the query to the mask: Masked is only the
                    # true submatrix system for u supported on it (Sec. 3.2)
                    us[i] = _host(r.u) * masks[i]
                    if r.t is not None:
                        ts[i] = r.t
                        has_t[i] = True
                with obs_spans.span("engine.lockstep_chunk",
                                    size=len(chunk)) as sp:
                    out = self._run(self._upload(us), self._upload(masks),
                                    self._upload(ts), self._upload(has_t))
                    sp.block_until_ready(out)
                lo, hi, dec, cert, it, conv = _read_back(*out)
            except Exception as e:
                # keep the un-served tail, but NOT the failing chunk: a
                # poison request requeued at the head would re-raise on
                # every flush and wedge everything behind it. The chunk's
                # requests carry the error so callers can tell "dropped
                # by a failed flush" from "never flushed".
                for r in chunk:
                    r.error = e
                    self._count("requests.errored")
                self._queue = queue[start + len(chunk):] + self._queue
                raise
            now = time.monotonic()
            for i, r in enumerate(chunk):
                r.lower, r.upper = float(lo[i]), float(hi[i])
                r.decision = bool(dec[i]) if r.t is not None else None
                r.certified = bool(cert[i])
                r.iterations = int(it[i])
                # same rule as the scheduler: resolved by the decision
                # OR by Krylov exhaustion (the bracket is then exact)
                r.resolved = bool(conv[i])
                self._retire_obs(r, now)
        return queue
