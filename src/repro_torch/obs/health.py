"""Online convergence health: bracket-gap logs + Thm. 4.2 rate checks
(counterpart of ``repro.obs.health``, the same names and verdicts).

The paper's central theorem guarantees the Gauss-Radau gap on
``u^T f(A) u`` contracts per iteration at least as fast as
``rho = ((sqrt(kappa)-1)/(sqrt(kappa)+1))^2`` for a spectral interval
of condition number kappa — in EXACT arithmetic. Finite-precision
Lanczos without reorthogonalization keeps the early contraction but
loses the superlinear finish: ghost Ritz values burn iterations and the
gap flattens out orders of magnitude above the f64 resolution floor
(paper Sec. 5.4 'Instability'; tests/test_convergence.py pins the
healthy behavior). This module turns that theorem into a runtime check:

* :class:`ConvergenceLog` records per-round per-lane brackets HOST-SIDE
  off returned :class:`~repro_torch.core.solver.QuadState` values, copied
  to the host (``.detach().cpu()`` for tensors on a card); the solver's
  loops are untouched, so logging is bit-invariant.
* :func:`check_contraction` / :class:`ContractionMonitor` fit the
  geometric rate (windowed, iteration-normalized) and flag lanes that
  (a) contract SLOWER than the theorem rate allows, (b) plateau while
  the gap is still live, or (c) exhaust the Krylov dimension with the
  gap still open — in exact arithmetic Lanczos on an n-dim system
  terminates by n steps with an exact bracket, so (c) is the classic
  lost-orthogonality diagnosis and the most robust reorth-off signal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def _host(x, dtype) -> np.ndarray:
    """``x`` as a numpy array of ``dtype``: a tensor (on any device) is
    copied to the host first (duck-typed: this module imports no torch)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def rate_bound(lam_min: float, lam_max: float) -> float:
    """Thm. 4.2 per-iteration contraction rate for the interval."""
    if not (0.0 < lam_min <= lam_max):
        raise ValueError(
            f"need 0 < lam_min <= lam_max, got [{lam_min}, {lam_max}]")
    rk = float(np.sqrt(lam_max / lam_min))
    return ((rk - 1.0) / (rk + 1.0)) ** 2


class ConvergenceLog:
    """Per-round record of (lower, upper, it), any lane shape.

    Recording happens AFTER the solver's calls return, on host copies of
    the state's ``lower``/``upper``/``it`` (tensors on a card are copied
    with ``.detach().cpu()``).
    """

    def __init__(self):
        self._lower: list = []
        self._upper: list = []
        self._it: list = []

    def record(self, lower, upper, it) -> None:
        lo = np.atleast_1d(_host(lower, np.float64))
        hi = np.atleast_1d(_host(upper, np.float64))
        itr = np.broadcast_to(np.atleast_1d(_host(it, np.int64)), lo.shape)
        if hi.shape != lo.shape:
            raise ValueError(
                f"lower/upper shape mismatch: {lo.shape} vs {hi.shape}")
        if self._lower and lo.shape != self._lower[0].shape:
            raise ValueError(
                f"lane shape changed mid-log: {self._lower[0].shape} -> "
                f"{lo.shape}")
        self._lower.append(lo.copy())
        self._upper.append(hi.copy())
        self._it.append(np.array(itr, np.int64))

    def record_state(self, state) -> None:
        """Record one round off a returned QuadState (host-side)."""
        lo, hi = state.bracket()
        self.record(lo, hi, state.it)

    def record_trace(self, tr) -> None:
        """Record a full :meth:`BIFSolver.trace` run — one round per
        quadrature iteration, Gauss-Radau brackets (iteration k is the
        k-th recorded estimate, matching the trace convention)."""
        lo = _host(tr.radau_lower, np.float64)
        hi = _host(tr.radau_upper, np.float64)
        for k in range(lo.shape[0]):
            self.record(lo[k], hi[k], k + 1)

    @property
    def rounds(self) -> int:
        return len(self._lower)

    def lowers(self) -> np.ndarray:
        """(rounds, lanes) lower bounds."""
        return np.stack(self._lower) if self._lower else \
            np.zeros((0, 0))

    def uppers(self) -> np.ndarray:
        return np.stack(self._upper) if self._upper else \
            np.zeros((0, 0))

    def its(self) -> np.ndarray:
        return np.stack(self._it) if self._it else \
            np.zeros((0, 0), np.int64)

    def gaps(self) -> np.ndarray:
        """(rounds, lanes) bracket gaps (upper - lower)."""
        return self.uppers() - self.lowers()

    def reset(self) -> None:
        self._lower.clear()
        self._upper.clear()
        self._it.clear()


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """Per-lane verdicts; ``flagged = slow | stalled | unresolved``."""
    bound: float                 # Thm. 4.2 rate for the interval
    fitted_rate: np.ndarray      # per-iteration geometric fit, live prefix
    max_window_rate: np.ndarray  # worst trailing-window rate observed
    last_rel_gap: np.ndarray     # final gap / lane scale
    slow: np.ndarray             # windowed rate > bound * rate_slack
    stalled: np.ndarray          # live plateau: windowed rate ~ 1
    unresolved: np.ndarray       # Krylov budget exhausted, gap still open
    flagged: np.ndarray

    @property
    def ok(self) -> bool:
        return not bool(self.flagged.any())


def _lane_scale(lowers: np.ndarray, uppers: np.ndarray) -> np.ndarray:
    s = np.maximum(np.abs(lowers), np.abs(uppers)).max(axis=0)
    return np.maximum(s, np.finfo(np.float64).tiny)


def check_contraction(log: ConvergenceLog, lam_min: float, lam_max: float,
                      *, window: int = 8, rate_slack: float = 1.15,
                      stall_ratio: float = 0.995, floor: float = 1e-8,
                      dim: Optional[int] = None,
                      resolved: Optional[Sequence[bool]] = None
                      ) -> HealthReport:
    """Check a recorded gap log against the Thm. 4.2 contraction rate.

    ``floor`` is the relative-gap resolution floor: lanes at or below it
    are converged and never flagged. ``dim`` (the system dimension, when
    the caller knows it) arms the exhaustion check: a gap still above
    the floor after ``dim`` Lanczos steps is impossible in exact
    arithmetic — the standard lost-orthogonality signature. ``resolved``
    masks lanes (e.g. threshold judges) that finished for reasons the
    gap cannot express.

    Rates are iteration-normalized — a log recorded every ``chunk``
    iterations (the engine's scheduler cadence) fits the same
    per-iteration rate as a per-iteration trace log.
    """
    lowers, uppers, its = log.lowers(), log.uppers(), log.its()
    rounds, lanes = lowers.shape
    nan = np.full((lanes,), np.nan)
    false = np.zeros((lanes,), bool)
    if rounds < 2:
        return HealthReport(rate_bound(lam_min, lam_max), nan, nan,
                            nan if rounds == 0 else
                            (uppers[-1] - lowers[-1]) /
                            _lane_scale(lowers, uppers),
                            false, false.copy(), false.copy(),
                            false.copy())

    bound = rate_bound(lam_min, lam_max)
    gaps = uppers - lowers
    scale = _lane_scale(lowers, uppers)
    rel = gaps / scale
    live = rel > floor

    fitted = np.full((lanes,), np.nan)
    max_win = np.full((lanes,), np.nan)
    slow = np.zeros((lanes,), bool)
    stalled = np.zeros((lanes,), bool)
    unresolved = np.zeros((lanes,), bool)
    skip = np.zeros((lanes,), bool)
    if resolved is not None:
        skip = np.asarray(resolved, bool).reshape((lanes,))

    for j in range(lanes):
        g, it, lv = gaps[:, j], its[:, j], live[:, j]
        # live prefix: stop at the first recorded round at/below floor
        m = rounds if lv.all() else int(np.argmin(lv))
        if m < 2:
            continue
        d_it = np.diff(it[:m])
        ok_pair = (d_it > 0) & (g[1:m] > 0.0) & (g[:m - 1] > 0.0)
        if ok_pair.any():
            logr = np.log(g[1:m][ok_pair] / g[:m - 1][ok_pair])
            fitted[j] = float(np.exp(logr.sum() / d_it[ok_pair].sum()))
        # trailing windows of `window` recorded rounds, per-iteration
        w = min(window, m - 1)
        rates = []
        for t in range(w, m):
            dit = int(it[t] - it[t - w])
            if dit > 0 and g[t - w] > 0.0 and g[t] > 0.0:
                rates.append((g[t] / g[t - w]) ** (1.0 / dit))
        if rates:
            max_win[j] = max(rates)
        if skip[j]:
            continue
        if rates and max(rates) > bound * rate_slack:
            slow[j] = True
        # plateau: the LAST window shows ~no contraction on a live gap
        if rates and lv[m - 1] and rates[-1] >= stall_ratio:
            stalled[j] = True
        # exhaustion: past the Krylov termination bound and still open
        if dim is not None and lv[-1] and int(its[-1, j]) >= dim - 2:
            unresolved[j] = True

    flagged = slow | stalled | unresolved
    return HealthReport(bound, fitted, max_win, rel[-1], slow, stalled,
                        unresolved, flagged)


class ContractionMonitor:
    """Online wrapper: feed rounds as they retire, ask for a report.

    >>> mon = ContractionMonitor(lam_min, lam_max, dim=n)
    >>> for _ in range(rounds):
    ...     state = solver.step_n(state, 8, convergence_log=mon.log)
    >>> mon.report().ok
    """

    def __init__(self, lam_min: float, lam_max: float, *,
                 window: int = 8, rate_slack: float = 1.15,
                 stall_ratio: float = 0.995, floor: float = 1e-8,
                 dim: Optional[int] = None):
        self.lam_min, self.lam_max = float(lam_min), float(lam_max)
        self.window = window
        self.rate_slack = rate_slack
        self.stall_ratio = stall_ratio
        self.floor = floor
        self.dim = dim
        self.log = ConvergenceLog()

    def observe(self, lower, upper, it) -> None:
        self.log.record(lower, upper, it)

    def observe_state(self, state) -> None:
        self.log.record_state(state)

    def report(self, *, resolved: Optional[Sequence[bool]] = None
               ) -> HealthReport:
        return check_contraction(
            self.log, self.lam_min, self.lam_max, window=self.window,
            rate_slack=self.rate_slack, stall_ratio=self.stall_ratio,
            floor=self.floor, dim=self.dim, resolved=resolved)
