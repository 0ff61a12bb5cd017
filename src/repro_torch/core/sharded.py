"""Multi-device quadrature lanes: the K lanes of the batched Alg. 2
driver split over the ranks of a lane mesh (counterpart of
``repro.core.sharded``; DESIGN.md Sec. 7, Sec. 11).

The reference runs ``shard_map`` over the devices of one process. Here
every rank is a process (SPMD, explicitly): each calls the entry point
with the same global inputs, the (K, N) queries, the thresholds and the
replicated operator, on its own device (``launch.make_lane_mesh``):

  * rank r owns the contiguous lanes ``[r kd, (r + 1) kd)`` of
    ``Kp = ceil(K / D) D``; K that does not divide by the D ranks is
    padded with zero-query lanes, which ``gql_init`` marks done at
    iteration one (padded stacked operator leaves are zeros, padded
    per-lane intervals ones);
  * spectrum estimation and preconditioning run on the global problem
    before the split, so every rank resolves the same interval;
  * every rank runs the single-device round loop on its shard
    (``BIFSolver._round_body``, ``_local_ok_fn``, ``_bracket2``), its
    kernels on its own device; lanes freeze bit-exactly as they resolve;
  * a round boundary pays exactly ONE collective, ``_round_gather`` of
    ``stack([lo, hi, can], -1)`` from (kd, 3) into (Kp, 3). Every rank
    evaluates ``decide`` on the gathered brackets, so cross-lane rules
    (the argmax race) see every lane, and derives its own needs-more
    slice and the global continue flag from the same bits: the ranks'
    trip counts stay in lockstep with no second collective. A rank whose
    lanes are all frozen skips the round's matvecs and still joins the
    gather;
  * ``finalize_sharded`` gathers the per-lane results once, so every
    rank returns the full result over the K lanes. The returned
    ``state`` is the rank's padded local shard; ``resume_sharded`` on the
    same ranks continues it bit-exactly.

``COUNTS`` keeps the collective accounting: ``gathers`` (calls of
``_round_gather``) = ``boundaries`` + ``finalizes`` + ``clocks``, and
``boundaries`` = ``rounds`` + ``drives`` (one gather before the first
round of a drive, one after each round). A solve is one drive and one
finalize: ``rounds + 2`` gathers. ``bytes`` is what this rank sent,
``gather_s`` the host seconds spent in the gathers.

On the CPU the group is gloo; on the card NCCL with a card per rank, or
gloo for ranks that share a card, where the round's few scalars travel
through pinned host buffers (gloo gathers host tensors only) and the
kernels stay on the card. Reorthogonalisation is not supported sharded,
as in the reference.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from . import block as _block
from . import gql as _gql
from . import matfun as _matfun
from . import operators as _ops
from .loop_utils import tree_map
from .solver import ArgmaxResult, BIFSolver, JudgeResult, QuadState, \
    SolveResult, _argmax_race, _argmax_scores, _bracket2, _bracket4, \
    _first_argmax

Tensor = torch.Tensor

# QuadState threading contract: per-lane fields the sharded driver does
# NOT thread. `basis` (reorth storage) is refused up front by
# _check_state, so the drive never carries or freezes it.
SHARDED_STATE_EXCLUDED = ("basis",)

COUNTS = {"gathers": 0, "bytes": 0, "boundaries": 0, "rounds": 0,
          "drives": 0, "finalizes": 0, "clocks": 0, "gather_s": 0.0}

# pinned host buffers of the gloo transport, by (shape, dtype, role)
_PINNED: dict = {}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _lanes(mesh, axis: str) -> tuple:
    """(ranks, this rank's index, process group) of the lane axis."""
    from ..launch.mesh import lane_rank
    ndev, rank = lane_rank(mesh, axis)
    return ndev, rank, mesh.get_group(axis)


def _host_buffer(shape, dtype, role: str) -> Tensor:
    key = (tuple(shape), dtype, role)
    buf = _PINNED.get(key)
    if buf is None:
        buf = torch.empty(shape, dtype=dtype,
                          pin_memory=torch.cuda.is_available())
        _PINNED[key] = buf
    return buf


def _staged(x: Tensor, group) -> bool:
    """Whether ``x`` travels through host memory: a device tensor on a
    gloo group."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _all_gather(out: Tensor, x: Tensor, group) -> None:
    # all_gather_single supersedes all_gather_into_tensor where it exists
    fn = (getattr(dist, "all_gather_single", None)
          # quadlint: disable=QL007 -- the cadence gather of _round_gather
          or dist.all_gather_into_tensor)
    fn(out, x, group=group)


def _round_gather(x: Tensor, mesh, axis: str, kind: str = "boundaries"
                  ) -> Tensor:
    """The cadence collective: the ONE all-gather a decision round pays.
    ``x`` is the rank's (kd, ...) block of per-lane values; returns the
    (D kd, ...) global stack on ``x``'s device, identical on every rank.
    ``kind`` names what the gather is for in ``COUNTS``."""
    ndev, _, group = _lanes(mesh, axis)
    t0 = time.perf_counter()
    x = x.contiguous()
    shape = (ndev * x.shape[0],) + tuple(x.shape[1:])
    if _staged(x, group):
        send = _host_buffer(x.shape, x.dtype, "send")
        send.copy_(x)
        recv = _host_buffer(shape, x.dtype, "recv")
        _all_gather(recv, send, group)
        out = recv.to(x.device)
    else:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        _all_gather(out, x, group)
    COUNTS["gathers"] += 1
    COUNTS[kind] += 1
    COUNTS["bytes"] += x.numel() * x.element_size()
    # host seconds in the collective, the wait for the slowest rank
    # included (on NCCL the gather's enqueue only)
    COUNTS["gather_s"] += time.perf_counter() - t0
    return out


def broadcast_from(x: Tensor, owner: int, mesh, axis: str = "lanes"
                   ) -> Tensor:
    """``x`` of the rank at lane-axis index ``owner``, on every rank (one
    broadcast; ``x`` has the same shape and dtype on every rank). The
    serving engine banks a lane this way."""
    ndev, rank, group = _lanes(mesh, axis)
    src = dist.get_global_rank(group, owner)
    x = x.contiguous()
    if _staged(x, group):
        buf = _host_buffer(x.shape, x.dtype, "bcast")
        buf.copy_(x)
        dist.broadcast(buf, src, group=group)
        out = buf.to(x.device)
    else:
        out = x.clone()
        dist.broadcast(out, src, group=group)
    return out


def agree_clock(now: float, mesh, axis: str = "lanes") -> float:
    """The latest of the ranks' clock readings ``now``, on every rank (one
    gather), so that host decisions made from a clock agree."""
    from ..launch.mesh import lane_device
    x = torch.tensor([now], dtype=torch.float64, device=lane_device(mesh))
    return float(_round_gather(x, mesh, axis, "clocks").max())


# ---------------------------------------------------------------------------
# Padding and the rank's shard


def _pad_rows(a: Tensor, kp: int, value=0) -> Tensor:
    """``a`` with its leading dim padded to ``kp`` rows of ``value``."""
    k = a.shape[0]
    if kp == k:
        return a
    pad = torch.full((kp - k,) + tuple(a.shape[1:]), value, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad])


def _pad_lane_arg(a, k: int, kp: int):
    """Zero-pad the leading lane dim of a (K, ...) decide argument to Kp;
    scalars and non-lane arrays pass as they are."""
    if not isinstance(a, torch.Tensor) or kp == k or a.ndim == 0 \
            or a.shape[0] != k:
        return a
    return _pad_rows(a, kp)


def _pad_lane_lam(lam: Tensor, k: int, kp: int) -> Tensor:
    """Pad a per-lane spectrum bound with ones (a harmless interval for
    the done-at-init padding lanes); a scalar bound passes."""
    if kp == k or lam.ndim == 0:
        return lam
    return _pad_rows(lam, kp, 1.0)


def _pad_lane_op(op, k: int, kp: int):
    """Zero-pad every lane-stacked operator leaf to Kp lanes: a padding
    lane's matvec is then 0, finite, which is all a done-at-init lane
    needs."""
    if kp == k:
        return op
    return _ops.map_stacked(
        op, lambda leaf: _pad_rows(torch.as_tensor(leaf), kp))


def shard_state(state: QuadState, mesh, axis: str = "lanes") -> QuadState:
    """This rank's shard of a global, padded (Kp,)-lane ``QuadState``
    (one made on a single device, or another package's state converted
    by ``convert.state_from_numpy``): per-lane leaves, per-lane intervals
    and stacked operator leaves cut to the rank's lanes. Kp must divide
    by the ranks."""
    ndev, rank, _ = _lanes(mesh, axis)
    if state.basis is not None:
        raise NotImplementedError(
            "reorth is not implemented for the sharded driver; a state "
            "with a basis cannot be sharded")
    kp = state.st.it.shape[0]
    if state.st.it.ndim != 1 or kp % ndev:
        raise ValueError(f"a state of lane shape {tuple(state.st.it.shape)}"
                         f" does not split over {ndev} ranks: it needs "
                         f"one lane axis of a multiple of {ndev} lanes")
    kd = kp // ndev
    mine = slice(rank * kd, (rank + 1) * kd)

    def rows(x):
        return x[mine] if x.ndim else x

    return state._replace(
        op=_ops.shard_ops(state.op, mesh, axis),
        st=tree_map(rows, state.st), coeffs=tree_map(rows, state.coeffs),
        lam_min=rows(state.lam_min), lam_max=rows(state.lam_max))


def _check_state(solver: BIFSolver, state: QuadState, what: str):
    if solver.config.reorth or state.basis is not None:
        raise NotImplementedError(
            f"reorth is not implemented for the sharded driver; "
            f"{what} requires reorth=False")
    if state.st.it.ndim != 1:
        raise ValueError(
            f"{what} wants a (K,)-lane state, got lane shape "
            f"{tuple(state.st.it.shape)}")


def _check_queries(solver: BIFSolver, u, what: str) -> None:
    b = solver.config.block_size
    if not isinstance(u, torch.Tensor):
        raise ValueError(f"{what} wants the queries as a tensor on the "
                         f"operator's device, got {type(u).__name__}")
    if b > 1:
        if u.ndim != 3 or u.shape[-2] != b:
            raise ValueError(
                f"{what} with block_size={b} wants (K, b, N) stacked "
                f"probe blocks with b={b}, got shape {tuple(u.shape)}")
    elif u.ndim != 2:
        raise ValueError(f"{what} wants (K, N) stacked queries, got shape "
                         f"{tuple(u.shape)}")


def _padded(k: int, ndev: int) -> int:
    return -(-k // ndev) * ndev


# ---------------------------------------------------------------------------
# The resumable sharded runtime: init / step_n / resume / finalize


def init_state_sharded(solver: BIFSolver, op, u: Tensor, *, mesh,
                       axis: str = "lanes", lam_min=None, lam_max=None,
                       probe=None) -> QuadState:
    """Prepare + iteration 1 of this rank's lanes. Spectrum estimation and
    preconditioning run on the global (K, N) problem, so the interval is
    the single-device one; the queries, the stacked operator leaves and
    per-lane intervals are then padded to Kp lanes and cut to the rank's
    kd, and ``gql_init`` (``block_init`` with ``block_size = b > 1`` on
    (K, b, N) probe blocks) runs on them. Returns the rank's padded local
    state; ``finalize_sharded(..., nlanes=K)`` slices the padding off."""
    cfg = solver.config
    if cfg.reorth:
        raise NotImplementedError(
            "reorth is not implemented for the sharded driver; "
            "init_state_sharded requires reorth=False")
    ndev, rank, _ = _lanes(mesh, axis)
    _check_queries(solver, u, "init_state_sharded")
    op, u, lam_min, lam_max = solver.prepare(op, u, lam_min, lam_max, probe)
    dev = u.device
    lam_min = torch.as_tensor(lam_min, dtype=u.dtype, device=dev)
    lam_max = torch.as_tensor(lam_max, dtype=u.dtype, device=dev)
    if cfg.block_size > 1:
        # estimating spectrum modes give per-probe bounds: the union
        # over the lane's block slots, as the single-device init takes
        if lam_min.ndim > 1:
            lam_min = torch.amin(lam_min, dim=-1)
        if lam_max.ndim > 1:
            lam_max = torch.amax(lam_max, dim=-1)
    k = u.shape[0]
    kp = _padded(k, ndev)
    u = _pad_rows(u, kp)
    op = _ops.shard_ops(_pad_lane_op(op, k, kp), mesh, axis)
    lam_min = _pad_lane_lam(lam_min, k, kp)
    lam_max = _pad_lane_lam(lam_max, k, kp)
    kd = kp // ndev
    mine = slice(rank * kd, (rank + 1) * kd)
    u = u[mine]
    lam_min = lam_min[mine] if lam_min.ndim else lam_min
    lam_max = lam_max[mine] if lam_max.ndim else lam_max
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.block_size > 1:
        st = _block.block_init(op, u, lam_min, lam_max, cfg.fn,
                               cfg.max_iters)
        coeffs = None
    else:
        st = _gql.gql_init(op, u, lam_min, lam_max)
        coeffs = _matfun.init_coeffs(st, cfg.fn, cfg.max_iters) \
            if cfg.fn != "inv" else None
    return QuadState(op=op, st=st, lam_min=lam_min, lam_max=lam_max,
                     basis=None, step=step, coeffs=coeffs)


def _drive_sharded(solver: BIFSolver, state: QuadState, decide,
                   decide_args, it_cap, mesh, axis: str,
                   n: int | None) -> QuadState:
    """Advance the rank's shard: ``n`` bounded steps (step_n) or to
    completion (``n=None``, resume).

    ``decide(lo, hi, *decide_args)`` sees the GLOBAL (Kp,) brackets and
    returns per-lane resolution flags; ``decide_args`` are the same on
    every rank, ``it_cap`` (per-lane budgets, (Kp,) or a scalar) is cut
    to the rank's lanes. Each trip runs ``R = decide_every`` shard-local
    steps (the single-device round body, collective-free) and then the
    one gather of the round boundary; ``n`` is quantised to whole rounds
    (``n // R``), as ``BIFSolver.step_n`` does, so sharded and
    single-device states stay round-aligned."""
    _check_state(solver, state, "the sharded stepping driver")
    ndev, rank, _ = _lanes(mesh, axis)
    r = solver.config.decide_every
    rounds = None if n is None else n // r
    if rounds == 0:
        return state
    kd = state.st.it.shape[0]
    mine = slice(rank * kd, (rank + 1) * kd)
    if decide is None:
        def decide(lo, hi):
            return solver.tolerance_resolved(lo, hi)
    cap = None
    if it_cap is not None:
        cap = torch.broadcast_to(torch.as_tensor(
            it_cap, dtype=torch.int32, device=state.st.it.device),
            (kd * ndev,))[mine]
    local_ok = solver._local_ok_fn(cap)
    round_fn = solver._round_body(state.op, state.lam_min, state.lam_max,
                                  solver._stepper(), local_ok)

    def boundary(st, coeffs):
        # ONE collective a round: the brackets and the local can-continue
        # flag travel together (the matfun and block brackets are
        # computed shard-local; only the scalars travel)
        lo, hi = _bracket2(st, coeffs, state.lam_min, state.lam_max)
        can = local_ok(st, coeffs)
        packed = _round_gather(torch.stack([lo, hi, can.to(lo.dtype)], -1),
                               mesh, axis)
        res = decide(packed[:, 0], packed[:, 1], *decide_args)
        nm_glob = packed[:, 2].to(torch.bool) & ~res
        nm = nm_glob[mine]
        # the round's one host read: the global continue flag (the same
        # bits on every rank) and whether this rank has work
        cont, busy = torch.stack([nm_glob.any(), nm.any()]).tolist()
        return nm, cont, busy

    COUNTS["drives"] += 1
    st, coeffs = state.st, state.coeffs
    nm, cont, busy = boundary(st, coeffs)
    taken = 0
    while cont and (rounds is None or taken < rounds):
        if busy:
            # a rank whose lanes are all frozen skips its matvecs (the
            # frozen substep is the identity) and still joins the gather
            st, _, coeffs, _, _ = round_fn((st, None, coeffs, state.step,
                                            nm))
        nm, cont, busy = boundary(st, coeffs)
        taken += 1
    COUNTS["rounds"] += taken
    # `step` is bookkeeping only without a basis: a whole round a trip,
    # the single-device round accounting
    return state._replace(st=st, coeffs=coeffs,
                          step=state.step + r * taken)


def step_n_sharded(solver: BIFSolver, state: QuadState, n: int,
                   decide=None, *, decide_args=(), it_cap=None, mesh,
                   axis: str = "lanes") -> QuadState:
    """Advance the rank's shard by at most ``n`` iterations, the sharded
    twin of ``BIFSolver.step_n`` (same freezing, so resume after step_n
    is bit-exact with the uninterrupted drive); ``n`` is quantised down
    to whole ``decide_every`` rounds, a no-op when ``n < R``."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if n == 0:
        return state
    return _drive_sharded(solver, state, decide, decide_args, it_cap,
                          mesh, axis, n)


def resume_sharded(solver: BIFSolver, state: QuadState, decide=None, *,
                   decide_args=(), it_cap=None, mesh,
                   axis: str = "lanes") -> QuadState:
    """Run the rank's shard to completion, the sharded twin of
    ``BIFSolver.resume``. Bit-exact resumes hold on the same rank count
    and rank that made the state."""
    return _drive_sharded(solver, state, decide, decide_args, it_cap,
                          mesh, axis, None)


def gather_lanes(x: Tensor, mesh, axis: str = "lanes") -> Tensor:
    """The (Kp, ...) global stack of per-lane results whose (kd, ...)
    block each rank holds: the one gather a finalize pays."""
    return _round_gather(x, mesh, axis, "finalizes")


def finalize_sharded(solver: BIFSolver, state: QuadState, decide=None, *,
                     decide_args=(), nlanes: int | None = None, mesh,
                     axis: str = "lanes") -> SolveResult:
    """The :class:`SolveResult` of a (partial or completed) sharded state
    over all lanes, on every rank: the per-lane brackets, iterations and
    done flags travel in one gather. ``certified`` evaluates ``decide``
    on the full padded brackets (cross-lane rules see every lane), then
    everything is sliced to ``nlanes``. ``state`` stays the rank's
    shard."""
    _check_state(solver, state, "finalize_sharded")
    st = state.st
    lo, hi, loose_lo, loose_hi = _bracket4(st, state.coeffs, state.lam_min,
                                           state.lam_max)
    packed = gather_lanes(torch.stack(
        [lo, hi, loose_lo, loose_hi, st.it.to(lo.dtype),
         st.done.to(lo.dtype)], -1), mesh, axis)
    lo, hi, loose_lo, loose_hi, it, done = packed.T.contiguous()
    if decide is None:
        certified = solver.tolerance_resolved(lo, hi)
    else:
        certified = decide(lo, hi, *decide_args)
    k = lo.shape[0] if nlanes is None else nlanes
    certified = certified[:k]
    return SolveResult(
        lower=lo[:k], upper=hi[:k], gauss_lower=loose_lo[:k],
        lobatto_upper=loose_hi[:k], iterations=it[:k].to(torch.int32),
        converged=done[:k].to(torch.bool) | certified,
        certified=certified, state=state)


# ---------------------------------------------------------------------------
# The batched entry points


def solve_batch_sharded(solver: BIFSolver, op, u: Tensor, decide=None, *,
                        mesh, axis: str = "lanes", lam_min=None,
                        lam_max=None, probe=None,
                        decide_args=()) -> SolveResult:
    """``BIFSolver.solve_batch`` with the K lanes split over ``mesh``.

    ``u`` is (K, N), or (K, b, N) with ``block_size = b > 1``: exactly
    one lane axis. ``decide(lo, hi, *decide_args)`` receives the global
    (Kp,) brackets (padding lanes carry zero queries and resolve at
    iteration one); each of ``decide_args`` with a leading dim of K is
    zero-padded to Kp. ``decide=None`` brackets each lane to the solver's
    rtol/atol. Returns the result over the K lanes on every rank, its
    ``state`` the rank's padded shard (``resume_sharded`` continues it)."""
    _lanes(mesh, axis)
    _check_queries(solver, u, "solve_batch_sharded")
    k = u.shape[0]
    state = init_state_sharded(solver, op, u, mesh=mesh, axis=axis,
                               lam_min=lam_min, lam_max=lam_max,
                               probe=probe)
    kp = state.st.it.shape[0] * _lanes(mesh, axis)[0]
    args = tuple(_pad_lane_arg(a, k, kp) for a in decide_args) \
        if decide is not None else ()
    state = resume_sharded(solver, state, decide, decide_args=args,
                           mesh=mesh, axis=axis)
    return finalize_sharded(solver, state, decide, decide_args=args,
                            nlanes=k, mesh=mesh, axis=axis)


def judge_batch_sharded(solver: BIFSolver, op, u: Tensor, t, *, mesh,
                        axis: str = "lanes", lam_min=None, lam_max=None,
                        probe=None) -> JudgeResult:
    """K threshold judges (Alg. 4) split over the lane mesh. With
    ``block_size = b > 1`` the lanes are (K, b, N) probe blocks and the
    thresholds apply to the per-lane ``tr B^T f(A) B`` brackets."""
    _lanes(mesh, axis)
    _check_queries(solver, u, "judge_batch_sharded")
    ts = torch.broadcast_to(torch.as_tensor(t, dtype=u.dtype,
                                            device=u.device), u.shape[:1])

    def decide(lo, hi, ts):
        return (ts < lo) | (ts >= hi)

    res = solve_batch_sharded(solver, op, u, decide, mesh=mesh, axis=axis,
                              lam_min=lam_min, lam_max=lam_max, probe=probe,
                              decide_args=(ts,))
    decision = BIFSolver.threshold_decision(ts, res.lower, res.upper)
    return JudgeResult(decision=decision, certified=res.certified,
                       iterations=res.iterations)


def judge_argmax_sharded(solver: BIFSolver, op, u: Tensor, *, mesh,
                         axis: str = "lanes", shift=None, scale=None,
                         valid=None, prior_upper=None, prior_lower=None,
                         lam_min=None, lam_max=None,
                         probe=None) -> ArgmaxResult:
    """The certified argmax race over K lanes split over the mesh. Each
    round every rank sees ALL lanes' brackets (the round gather), computes
    the same dominance and winner flags as the single-device race, and
    freezes its dominated lanes. Padding lanes ride along with
    ``valid=False`` (the -1e30 score sentinel), so they neither win nor
    keep the loop alive."""
    ndev, _, _ = _lanes(mesh, axis)
    _check_queries(solver, u, "judge_argmax_sharded")
    k = u.shape[0]

    def lanes(x, default, dtype=u.dtype):
        return torch.broadcast_to(torch.as_tensor(
            default if x is None else x, dtype=dtype, device=u.device), (k,))

    shift_k, scale_k = lanes(shift, 0.0), lanes(scale, 1.0)
    valid_k = lanes(valid, True, torch.bool)
    # padding lanes enter the race invalid
    valid_p = _pad_rows(valid_k, _padded(k, ndev))
    prior_k = None if prior_upper is None else lanes(prior_upper, None)
    prior_lo_k = None if prior_lower is None else lanes(prior_lower, None)

    if prior_k is None and prior_lo_k is None:
        def decide(lo, hi, shift, scale, valid):
            dominated, winner = _argmax_race(
                *_argmax_scores(lo, hi, shift, scale, valid))
            return dominated | winner

        dargs = (shift_k, scale_k, valid_p)
    else:
        # a missing prior rides as a no-op sentinel (+/-inf clamps to the
        # lane's own bracket); padding lanes are pinned by `valid` after
        # the clamps, so their zero-padded priors are harmless
        pu_k = lanes(float("inf"), None) if prior_k is None else prior_k
        pl_k = lanes(float("-inf"), None) if prior_lo_k is None \
            else prior_lo_k

        def decide(lo, hi, shift, scale, valid, pu, pl):
            dominated, winner = _argmax_race(
                *_argmax_scores(lo, hi, shift, scale, valid, pu, pl))
            return dominated | winner

        dargs = (shift_k, scale_k, valid_p, pu_k, pl_k)

    res = solve_batch_sharded(
        solver, op, u, decide, mesh=mesh, axis=axis, lam_min=lam_min,
        lam_max=lam_max, probe=probe, decide_args=dargs)
    slo, shi = _argmax_scores(res.lower, res.upper, shift_k, scale_k,
                              valid_k, prior_k, prior_lo_k)
    _, winner = _argmax_race(slo, shi)
    certified = torch.any(winner, dim=-1)
    mid = 0.5 * (slo + shi)
    index = torch.where(certified, _first_argmax(winner),
                        _first_argmax(mid)).to(torch.int32)
    return ArgmaxResult(index=index, certified=certified,
                        iterations=res.iterations, lower=slo, upper=shi)


def judge_kdpp_swap_batch_sharded(solver: BIFSolver, op, u: Tensor,
                                  v: Tensor, t, p, *, mesh,
                                  axis: str = "lanes", lam_min=None,
                                  lam_max=None) -> JudgeResult:
    """Alg. 7 with the two systems as two sharded lanes (further ranks
    carry padding lanes: worth it only inside a larger sharded pipeline,
    such as a mesh-resident k-DPP chain)."""
    if solver.config.block_size > 1:
        raise NotImplementedError(
            "judge_kdpp_swap_batch_sharded stacks two scalar query "
            "systems; block_size > 1 brackets tr B^T f(A) B and has no "
            "swap-judge semantics — use block_size=1")
    uv = torch.stack([u, v], dim=0)
    t = torch.as_tensor(t, dtype=uv.dtype, device=uv.device)
    p = torch.as_tensor(p, dtype=uv.dtype, device=uv.device)

    def bounds(lo, hi):
        return (p * lo[..., 1] - hi[..., 0],
                p * hi[..., 1] - lo[..., 0])

    def decide(lo, hi, t, p):
        blo, bhi = bounds(lo, hi)
        done = (t < blo) | (t >= bhi)
        return torch.broadcast_to(done[..., None], lo.shape)

    res = solve_batch_sharded(solver, op, uv, decide, mesh=mesh, axis=axis,
                              lam_min=lam_min, lam_max=lam_max,
                              decide_args=(t, p))
    blo, bhi = bounds(res.lower, res.upper)
    return JudgeResult(decision=BIFSolver.threshold_decision(t, blo, bhi),
                       certified=(t < blo) | (t >= bhi),
                       iterations=torch.sum(res.iterations, dim=-1,
                                            dtype=res.iterations.dtype))


@dataclasses.dataclass(frozen=True)
class ShardedBIFSolver:
    """A :class:`BIFSolver` bound to a lane mesh::

        mesh = make_lane_mesh()                  # every rank of the group
        sh = ShardedBIFSolver(BIFSolver.create(max_iters=64), mesh)
        res = sh.judge_argmax(op, us, shift=d, scale=-1.0)
    """
    solver: BIFSolver
    mesh: object
    axis: str = "lanes"

    def solve_batch(self, op, u: Tensor, decide=None, **kw) -> SolveResult:
        return solve_batch_sharded(self.solver, op, u, decide,
                                   mesh=self.mesh, axis=self.axis, **kw)

    def judge_batch(self, op, u: Tensor, t, **kw) -> JudgeResult:
        return judge_batch_sharded(self.solver, op, u, t, mesh=self.mesh,
                                   axis=self.axis, **kw)

    def judge_argmax(self, op, u: Tensor, **kw) -> ArgmaxResult:
        return judge_argmax_sharded(self.solver, op, u, mesh=self.mesh,
                                    axis=self.axis, **kw)

    def judge_kdpp_swap_batch(self, op, u: Tensor, v: Tensor, t, p,
                              **kw) -> JudgeResult:
        return judge_kdpp_swap_batch_sharded(
            self.solver, op, u, v, t, p, mesh=self.mesh, axis=self.axis,
            **kw)
