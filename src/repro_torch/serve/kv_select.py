"""Log-det KV diversification, PyTorch port (counterpart of
``repro.serve.kv_select``; paper tie-in #3, DESIGN.md Sec. 4.3).

Long-context decode keeps a KV budget per layer. To choose WHICH entries
to keep, we run the paper's retrospective double greedy (Alg. 8/9) on
F(S) = log det(K_S) over a key-similarity kernel: the kept subset is
provably within 1/2 of the max-diversity subset, and every keep/evict
decision is certified by Gauss-Radau brackets rather than exact solves.

This operates on pooled key blocks (block-mean keys), so the ground set
stays ~hundreds even for 500k contexts.

The rankers build their kernel operator on ``device`` (the card by
default, as ``convert.operator_from_numpy``); pooling and the kernel
itself are numpy, as in the reference. ``select_diverse_blocks`` takes
its Alg. 8 uniforms from a ``torch.Generator`` seeded with ``seed``, or
from ``uniforms`` (a table or a generator). ``mesh=`` (a lane mesh,
``launch.make_lane_mesh``) goes to the ranker's ``BIFEngine``, which
splits its pool over the mesh's ranks; every rank calls the ranker with
the same keys and gets the same ranking.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import double_greedy as dg
from ..core import operators as core_ops
from ..core import spectrum as core_spectrum
from ..core.solver import BIFSolver, SolverConfig
from .engine import BIFEngine, BIFRequest


def pool_keys(keys: np.ndarray, block: int = 128) -> np.ndarray:
    """(S, D) keys -> (ceil(S/block), D) block-mean summaries, L2-normalized.

    The trailing partial block (``S % block`` keys) pools into a final
    partial-block summary — the mean over the keys it actually holds —
    instead of being silently dropped (it used to be truncated away, so
    up to ``block - 1`` tail keys were never scored and
    :func:`apply_block_mask` padded them as always-kept)."""
    s, d = keys.shape
    n = -(-s // block)
    pad = n * block - s
    padded = np.concatenate([keys, np.zeros((pad, d), keys.dtype)]) \
        if pad else keys
    counts = np.minimum(block, s - np.arange(n) * block)
    pooled = padded.reshape(n, block, d).sum(1) / counts[:, None]
    return pooled / (np.linalg.norm(pooled, axis=-1, keepdims=True) + 1e-8)


def _lam_min(ridge: float) -> float:
    """The rankers' certified lower spectral bound: half the ridge, which
    every K + ridge I (and every principal submatrix of it, padded with
    identity rows) lies above, as ``select_diverse_blocks`` uses.

    The reference takes the engine's Gershgorin interval here, whose
    lam_min floor is 1e-9 lam_max. On the f32 kernel the left Radau end
    then cancels catastrophically (values of +-1e4 and beyond in the
    first iterations) and the tolerance rule certifies inverted brackets
    (ROADMAP Queue 3); with the ridge every bracket holds its truth."""
    return 0.5 * ridge


def _rbf_kernel(pooled: np.ndarray, ridge: float,
                bandwidth: float) -> np.ndarray:
    """RBF similarity kernel over block summaries, ridge-regularized
    (shared by the one-shot rankers and the streaming BlockRanker so
    their systems are bit-identical)."""
    n = len(pooled)
    d2 = ((pooled[:, None, :] - pooled[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2 / (2 * bandwidth ** 2)) + ridge * np.eye(n)


def select_diverse_blocks(keys: np.ndarray, *, block: int = 128,
                          ridge: float = 1e-3, bandwidth: float = 0.5,
                          seed: int = 0,
                          solver_config: SolverConfig | None = None,
                          uniforms=None, device="cuda"):
    """Returns (block_mask, stats): which key blocks to keep.

    The retrospective double greedy maximizes log det of the RBF kernel
    over block summaries; `stats.quad_iterations` shows the certified
    early-stopping at work. ``solver_config`` tunes the quadrature engine
    (e.g. ``SolverConfig(max_iters=32, backend='pallas')`` on the card);
    the default matches the exhaustive-certainty setting. Alg. 8 draws
    one uniform per block: from a ``torch.Generator`` seeded with
    ``seed``, or from ``uniforms`` (an (n,) table or a generator) when
    given.
    """
    pooled = pool_keys(keys, block)
    n = len(pooled)
    kmat = _rbf_kernel(pooled, ridge, bandwidth)
    dev = core_ops.resolve_device(device)
    op = core_ops.Dense(torch.tensor(kmat, dtype=torch.float32, device=dev))
    if solver_config is None:
        solver_config = SolverConfig(max_iters=n + 2)
    if uniforms is None:
        uniforms = torch.Generator().manual_seed(seed)
    res = dg.double_greedy(op, uniforms, ridge * 0.5,
                           float(n) + 1.0, max_iters=solver_config.max_iters,
                           solver=BIFSolver(solver_config))
    mask = res.selected.cpu().numpy() > 0.5
    return mask, {"quad_iterations": int(res.quad_iterations),
                  "uncertified": int(res.uncertified),
                  "log_det": float(res.log_det),
                  "kept": int(mask.sum()), "blocks": n}


def rank_blocks(keys: np.ndarray, *, block: int = 128, ridge: float = 1e-3,
                bandwidth: float = 0.5, max_batch: int = 32,
                bucket: int = 32, mesh=None,
                solver_config: SolverConfig | None = None,
                coarse_iters: int | None = None, device="cuda"):
    """Certified redundancy ranking of pooled key blocks, served batched.

    Block i's score is the leverage-style bilinear form
    ``k_i[-i]^T K_{-i}^-1 k_i[-i]``: its kernel column against the
    system with block i itself *excluded* (via the request mask) — high
    means block i is well explained by the others (safe to evict first).
    Excluding i matters: against the full K the form collapses to
    ``K_ii = 1 + ridge`` identically for every block. All N candidate
    BIFs go through a :class:`BIFEngine` lane pool: one continuous-
    batching scheduler instead of N sequential solves.

    ``coarse_iters`` turns on the two-phase warm-started ranking of
    DESIGN.md Sec. 8.3: phase 1 brackets every block under a small
    per-request iteration budget; only blocks whose bracket still
    overlaps another block's (rank-ambiguous) are resubmitted — carrying
    their banked :class:`~repro.core.solver.QuadState` — and resume
    where they stopped instead of re-solving from scratch. Blocks whose
    coarse bracket already separates keep their cheap answer.

    The kernel's system size is padded to a multiple of ``bucket``
    (identity rows, masked out of every request), so nearby block counts
    land on one flush-driver signature across calls whose ``n`` falls in
    the same bucket (pinned in tests via
    ``serve.engine.flush_trace_count``). The kernel operator lives on
    ``device``; ``mesh`` splits the engine's pool over a lane mesh.
    The spectral interval is ``[ridge / 2, Gershgorin max]`` (``_lam_min``).

    Returns ``(order, stats)`` with ``order`` the block indices most-
    redundant first and per-block certified brackets in ``stats``.
    """
    pooled = pool_keys(keys, block)
    n = len(pooled)
    n_pad = -(-n // bucket) * bucket
    kmat = _rbf_kernel(pooled, ridge, bandwidth)
    kfull = np.eye(n_pad, dtype=np.float32)
    kfull[:n, :n] = kmat
    op = core_ops.Dense(torch.tensor(kfull,
                                     device=core_ops.resolve_device(device)))
    if solver_config is None:
        # ceiling derived from the BUCKETED size so every call in the
        # bucket shares one (static) solver config
        solver_config = SolverConfig(max_iters=min(n_pad + 2, 64),
                                     rtol=1e-3)
    engine = BIFEngine(op, solver=BIFSolver(solver_config),
                       max_batch=max_batch, mesh=mesh,
                       lam_min=_lam_min(ridge))
    base_mask = np.zeros(n_pad, dtype=np.float32)
    base_mask[:n] = 1.0
    reqs = []
    for i in range(n):
        mask = base_mask.copy()
        mask[i] = 0.0
        u = np.zeros(n_pad, dtype=np.float32)
        u[:n] = kmat[:, i]
        reqs.append(engine.submit(BIFRequest(u=u, mask=mask,
                                             max_iters=coarse_iters)))
    engine.flush()
    flushes = 1
    refined = 0
    if coarse_iters is not None:
        los = np.array([r.lower for r in reqs])
        his = np.array([r.upper for r in reqs])
        for i, r in enumerate(reqs):
            if r.resolved:
                continue  # already at the solver's tolerance
            # rank-ambiguous: bracket overlaps some other block's
            others = np.arange(n) != i
            if np.any((los[others] < his[i]) & (los[i] < his[others])):
                r.max_iters = None  # full budget; resumes banked state
                engine.submit(r)
                refined += 1
        if refined:
            engine.flush()
            flushes += 1
    mids = np.array([0.5 * (r.lower + r.upper) for r in reqs])
    order = np.argsort(-mids)
    return order, {
        "brackets": [(r.lower, r.upper) for r in reqs],
        "iterations": int(sum(r.iterations for r in reqs)),
        "certified": int(sum(r.certified for r in reqs)),
        "resolved": int(sum(bool(r.resolved) for r in reqs)),
        "refined": refined,
        # scheduler passes over the lane pool (the continuous engine has
        # no per-max_batch chunks; each flush call is one scheduler run)
        "flushes": flushes, "blocks": n}


class BlockRanker:
    """Streaming certified redundancy ranking of a GROWING KV cache.

    :func:`rank_blocks` re-solves all N blocks from scratch on every
    call; during decode the cache grows by one block at a time, so that
    rebuilds the engine and re-pays N solves to re-rank a ground set
    that changed by one item. ``BlockRanker`` instead maintains the
    padded kernel operator and one :class:`BIFEngine` across cache
    growth:

      * ``extend(keys)`` appends raw keys; ``rank()`` re-pools, grows
        the kernel, and, as long as the padded system size stays inside
        the current ``bucket``, swaps the new operator into the LIVE
        engine in place (the engine's flush drivers read ``engine.op`` at
        call time, so the swap meets no new driver signature; pinned via
        ``flush_trace_count``). Only a bucket overflow rebuilds the
        engine.
      * each ``rank()`` re-solves only the *changed* blocks (new blocks,
        plus a trailing partial block whose summary absorbed new keys)
        and the *rank-ambiguous* neighbors — previously-scored blocks
        whose banked bracket overlaps a changed block's fresh bracket,
        so their relative order is genuinely in doubt. Everything else
        keeps its banked bracket: no resubmission, no iterations.
      * within a ``rank()``, re-solves run the two-phase warm-started
        schedule of :func:`rank_blocks` when ``coarse_iters`` is set:
        coarse brackets first, then only still-ambiguous unresolved
        blocks resubmit carrying their banked
        :class:`~repro_torch.core.solver.QuadState` and resume where
        they stopped.

    The streaming tradeoff, documented here because it is the point:
    a kept (non-resubmitted) block's banked score was computed against
    the SMALLER ground set. Leverage scores are non-DEcreasing as the
    cache grows (more blocks explain you at least as well — the Schur-
    complement monotonicity of DESIGN.md Sec. 12 read in reverse), so
    banked brackets stay valid LOWER bounds but their uppers can go
    stale. ``rank()`` treats bracket overlap against the freshly-solved
    blocks as the re-solve trigger; well-separated stale blocks keep
    their cheap answer. Callers who need every bracket current for the
    full ground set should call :func:`rank_blocks`.

    ``rank()`` returns ``(order, info)`` like :func:`rank_blocks`;
    ``info`` additionally reports ``solved`` (fresh re-solves),
    ``reused`` (banked brackets kept) and per-call ``iterations`` /
    ``flushes``. ``self.stats`` accumulates across calls.
    """

    def __init__(self, *, block: int = 128, ridge: float = 1e-3,
                 bandwidth: float = 0.5, max_batch: int = 32,
                 bucket: int = 32, mesh=None,
                 solver_config: SolverConfig | None = None,
                 coarse_iters: int | None = None, device="cuda"):
        self.block = int(block)
        self.ridge = float(ridge)
        self.bandwidth = float(bandwidth)
        self.max_batch = int(max_batch)
        self.bucket = int(bucket)
        self.mesh = mesh
        self.solver_config = solver_config
        self.coarse_iters = coarse_iters
        self.device = core_ops.resolve_device(device)
        self._keys: np.ndarray | None = None   # raw (S, D) key buffer
        self._kmat: np.ndarray | None = None
        self._engine: BIFEngine | None = None
        self._n_pad = 0
        # per-block banked results from the last rank(): parallel lists
        self._reqs: list[BIFRequest] = []
        self._sizes: np.ndarray = np.zeros(0, np.int64)  # keys per block
        self.stats = {"iterations": 0, "flushes": 0, "solved": 0,
                      "refined": 0, "reused": 0, "engine_builds": 0}

    def extend(self, keys: np.ndarray) -> "BlockRanker":
        """Append raw keys (the cache grew); returns self for chaining."""
        keys = np.asarray(keys)
        if keys.ndim != 2:
            raise ValueError(f"keys must be (S, D), got {keys.shape}")
        self._keys = keys if self._keys is None \
            else np.concatenate([self._keys, keys])
        return self

    # -- internals ---------------------------------------------------------

    def _sync_engine(self, n: int) -> None:
        """Point the live engine at the grown kernel — in place when the
        padded size stays inside the current bucket."""
        n_pad = -(-n // self.bucket) * self.bucket
        kfull = np.eye(n_pad, dtype=np.float32)
        kfull[:n, :n] = self._kmat
        op = core_ops.Dense(torch.tensor(kfull, device=self.device))
        if self._engine is not None and self._n_pad == n_pad:
            # in-place operator swap: the flush drivers read engine.op /
            # engine.lam_* at call time, so the driver signature repeats
            # (no new count for same-bucket growth). Refresh the upper
            # end of the interval with the SAME estimator the engine ctor
            # uses (the lower end is the ridge), so streaming brackets
            # stay bit-identical to a cold rank_blocks on the grown cache.
            est = core_spectrum.gershgorin_bounds_spd(op)
            self._engine.op = op
            self._engine.lam_max = float(est.lam_max)
            return
        cfg = self.solver_config
        if cfg is None:
            cfg = SolverConfig(max_iters=min(n_pad + 2, 64), rtol=1e-3)
        self._engine = BIFEngine(op, solver=BIFSolver(cfg),
                                 max_batch=self.max_batch, mesh=self.mesh,
                                 lam_min=_lam_min(self.ridge))
        self._n_pad = n_pad
        self.stats["engine_builds"] += 1

    def _fresh_request(self, i: int, n: int,
                       max_iters: int | None) -> BIFRequest:
        """Block i's leverage query against the CURRENT ground set."""
        mask = np.zeros(self._n_pad, dtype=np.float32)
        mask[:n] = 1.0
        mask[i] = 0.0
        u = np.zeros(self._n_pad, dtype=np.float32)
        u[:n] = self._kmat[:, i]
        return BIFRequest(u=u, mask=mask, max_iters=max_iters)

    # -- the streaming rank ------------------------------------------------

    def rank(self):
        """Re-rank the current cache; returns ``(order, info)``."""
        if self._keys is None or len(self._keys) == 0:
            raise ValueError("no keys: call extend() first")
        pooled = pool_keys(self._keys, self.block)
        n = len(pooled)
        self._kmat = _rbf_kernel(pooled, self.ridge, self.bandwidth)
        self._sync_engine(n)
        eng = self._engine

        # changed blocks must re-solve: brand-new ones, plus a partial
        # tail block whose summary absorbed fresh keys (keys are append-
        # only, so same key-count == same contents)
        sizes = np.minimum(self.block,
                           len(self._keys) - np.arange(n) * self.block)
        n_old = len(self._sizes)
        changed = [i for i in range(n)
                   if i >= n_old or sizes[i] != self._sizes[i]]
        self._sizes = sizes
        self._reqs = self._reqs[:n] + [None] * (n - len(self._reqs))

        # phase 1: fresh solves for the changed blocks (new ground set ->
        # new (u, mask) -> banked states don't transfer; submit() clears
        # the stale results)
        for i in changed:
            self._reqs[i] = eng.submit(
                self._fresh_request(i, n, self.coarse_iters))
        flushes = 0
        if changed:
            eng.flush()
            flushes += 1

        # phase 2: previously-scored blocks whose banked bracket overlaps
        # a changed block's fresh bracket are rank-ambiguous — their
        # order against the newcomers is in doubt — and re-solve against
        # the grown ground set. Others keep their banked (valid-lower,
        # possibly stale-upper) bracket: the streaming tradeoff.
        chg = set(changed)
        if chg and len(chg) < n:
            clo = np.array([self._reqs[i].lower for i in changed])
            chi = np.array([self._reqs[i].upper for i in changed])
            ambiguous = [
                i for i in range(n) if i not in chg
                and np.any((clo < self._reqs[i].upper)
                           & (self._reqs[i].lower < chi))]
            for i in ambiguous:
                self._reqs[i] = eng.submit(
                    self._fresh_request(i, n, self.coarse_iters))
            if ambiguous:
                eng.flush()
                flushes += 1
            solved = changed + ambiguous
        else:
            solved = changed

        # phase 3: two-phase refinement inside this call — unresolved
        # coarse solves that still overlap each other resume their
        # banked QuadState under the full budget (rank_blocks' schedule)
        refined = 0
        if self.coarse_iters is not None and solved:
            los = np.array([r.lower for r in self._reqs])
            his = np.array([r.upper for r in self._reqs])
            for i in solved:
                r = self._reqs[i]
                if r.resolved:
                    continue
                others = np.arange(n) != i
                if np.any((los[others] < his[i]) & (los[i] < his[others])):
                    r.max_iters = None  # full budget; resumes banked state
                    eng.submit(r)
                    refined += 1
            if refined:
                eng.flush()
                flushes += 1

        mids = np.array([0.5 * (r.lower + r.upper) for r in self._reqs])
        order = np.argsort(-mids)
        info = {
            "blocks": n,
            "solved": len(solved),
            "refined": refined,
            "reused": n - len(solved),
            "flushes": flushes,
            # every re-solved block started from scratch THIS call and
            # in-call refinement accumulates through its banked state,
            # so the final counters of the solved set are the call cost;
            # reused blocks cost zero
            "iterations": int(sum(int(self._reqs[i].iterations or 0)
                                  for i in solved)),
            "brackets": [(r.lower, r.upper) for r in self._reqs],
        }
        for k in ("iterations", "flushes", "solved", "refined", "reused"):
            self.stats[k] += info[k]
        return order, info


def apply_block_mask(cache_k: torch.Tensor, cache_v: torch.Tensor,
                     mask: np.ndarray, block: int = 128):
    """Zero out evicted blocks of (B, S, H, D) caches (a real engine would
    compact; zeroing keeps shapes static and attention ignores evicted
    keys via -inf scores when combined with the validity mask)."""
    s = cache_k.shape[1]
    # ceil-block masks (pool_keys) cover the tail: the last (partial)
    # block's decision applies to its actual keys, so slice the repeat
    # down to the cache length. A short mask (legacy truncating pooling)
    # still pads its uncovered tail as kept.
    full = np.repeat(mask, block)
    if len(full) < s:
        full = np.pad(full, (0, s - len(full)), constant_values=True)
    m = torch.as_tensor(full[:s], dtype=cache_k.dtype,
                        device=cache_k.device)[None, :, None, None]
    return cache_k * m, cache_v * m
