"""The port's multi-rank lane checks: the rank side of
tests/test_torch_sharded.py.

    PYTHONPATH=src python tests/torch_sharded_ranks.py WORLD INPUTS OUT

spawns WORLD gloo ranks on the CPU (a ``FileStore`` in OUT, a 60 s group
timeout, one thread a rank). Every rank reads the pickled INPUTS (the
seeded numpy problems of ``build_inputs`` plus the reference's draws,
probes and banked state, which the test adds), runs every case of
``CASES`` through the port's ``mesh=`` entry points and pickles its
results to ``OUT/rank<r>.pkl``: a dict ``{case: {name: numpy array}}``.
The test holds them to the JAX package's single-device results. This
file imports no JAX and nothing of ``repro``; the parent imports it for
``build_inputs`` and ``make_spd``.
"""
from __future__ import annotations

import os
import pickle
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

JOIN_TIMEOUT_S = 120.0


def make_spd(n: int, kappa: float = 100.0, seed: int = 0,
             density: float = 1.0) -> np.ndarray:
    """Random SPD matrix with a controlled condition number: a copy of
    tests/conftest.py's ``make_spd``, which the ranks cannot import (that
    file imports JAX)."""
    rng = np.random.default_rng(seed)
    if density < 1.0:
        m = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
        a = (m + m.T) / 2
        w = np.linalg.eigvalsh(a)
        span = w[-1] - w[0]
        lam_min = max(span, 1e-3) / (kappa - 1)
        return a + np.eye(n) * (lam_min - w[0])
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    evals = np.geomspace(1.0 / kappa, 1.0, n)
    return (q * evals) @ q.T


def problem(n=48, k=16, kappa=150.0, seed=0, density=0.3):
    """(a, us, truths u^T A^-1 u, lam_min, lam_max) from the seed."""
    a = make_spd(n, kappa=kappa, seed=seed, density=density)
    w = np.linalg.eigvalsh(a)
    us = np.random.default_rng(seed + 1).standard_normal((k, n))
    true = np.einsum("ki,ki->k", us, np.linalg.solve(a, us.T).T)
    return a, us, true, float(w[0] * 0.99), float(w[-1] * 1.01)


def greedy_kernel(n=28):
    """The unit-diagonal kernel of the greedy-MAP and k-DPP cases."""
    a = make_spd(n, kappa=60.0, seed=7)
    d = np.sqrt(np.diag(a))
    a = a / np.outer(d, d) + 0.1 * np.eye(n)
    w = np.linalg.eigvalsh(a)
    return a, float(w[0] * 0.99), float(w[-1] * 1.01)


def engine_traffic():
    """The mixed traffic of the engine case: 13 requests over a 32-item
    kernel, brackets and judges 10% off their truth, one masked, one
    bracket with a 3-iteration budget (resubmitted without it)."""
    a = make_spd(32, kappa=60.0, seed=2)
    w = np.linalg.eigvalsh(a)
    rng = np.random.default_rng(4)
    us = rng.standard_normal((13, 32))
    true = np.einsum("ki,ki->k", us, np.linalg.solve(a, us.T).T)
    mask = (rng.random(32) < 0.5).astype(float)
    reqs = []
    for i, u in enumerate(us):
        t = float(true[i] * (0.9 if i % 2 else 1.1)) if i % 3 else None
        reqs.append(dict(u=u, t=t, mask=mask if i == 10 else None,
                         max_iters=3 if i == 6 else None))
    return a, float(w[0] * 0.9), float(w[-1] * 1.1), reqs


def build_inputs() -> dict:
    """The seeded numpy problems every case reads (the parent adds the
    reference's draws, probes and banked state)."""
    return {"engine": engine_traffic(), "greedy": greedy_kernel()}


# ---------------------------------------------------------------------------
# The rank side: the port through its mesh= entry points


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _solve_out(res) -> dict:
    return {f: _np(getattr(res, f)) for f in (
        "lower", "upper", "gauss_lower", "lobatto_upper", "iterations",
        "converged", "certified")}


LOOSE = ("gauss_lower", "lobatto_upper")


def _counted(fn):
    """``fn()`` with the sharded module's collective counts of the call."""
    from repro_torch.core import sharded
    sharded.reset_counts()
    out = fn()
    return out, dict(sharded.COUNTS)


def case_solve(inp, mesh, T):
    a, us, _, lmn, lmx = problem()
    s = T.BIFSolver.create(max_iters=50, rtol=1e-4)
    out = {}
    for kind, op in (("dense", T.Dense(torch.tensor(a))),
                     ("coo", T.sparse_from_dense(a, device="cpu")),
                     ("bell", T.bell_from_dense(a, bs=16, device="cpu"))):
        res, counts = _counted(lambda: s.solve_batch_sharded(
            op, torch.tensor(us), mesh=mesh, lam_min=lmn, lam_max=lmx))
        out.update({f"{kind}/{k}": v for k, v in _solve_out(res).items()})
        out[f"{kind}/gathers"] = np.array([counts["gathers"],
                                           counts["rounds"]])
        out[f"{kind}/step"] = _np(res.state.step)
    return out


def case_padded_masks(inp, mesh, T):
    """K = 11 lanes over stacked masks (padding lanes on every D > 1)."""
    a, us, _, lmn, lmx = problem(k=11, seed=3)
    s = T.BIFSolver.create(max_iters=50, rtol=1e-4)
    masks = (np.random.default_rng(5).random((11, a.shape[0])) < 0.6
             ).astype(float)
    mop = T.stack_masks(T.Dense(torch.tensor(a)), torch.tensor(masks))
    res = s.solve_batch_sharded(mop, torch.tensor(us * masks), mesh=mesh,
                                lam_min=lmn, lam_max=lmx)
    return _solve_out(res)


def case_stacked_ops(inp, mesh, T):
    """Eight different systems (stack_ops): per-lane leaves split."""
    n, k = 32, 8
    mats = [make_spd(n, kappa=60.0, seed=s) for s in range(k)]
    w = [np.linalg.eigvalsh(m) for m in mats]
    lmn = min(v[0] for v in w) * 0.99
    lmx = max(v[-1] for v in w) * 1.01
    us = torch.tensor(np.random.default_rng(9).standard_normal((k, n)))
    s = T.BIFSolver.create(max_iters=n + 2, rtol=1e-4)
    out = {}
    for kind, build in (("coo", lambda m: T.sparse_from_dense(
            m, device="cpu")), ("bell", lambda m: T.bell_from_dense(
                m, bs=16, device="cpu"))):
        res = s.solve_batch_sharded(T.stack_ops([build(m) for m in mats]),
                                    us, mesh=mesh, lam_min=lmn, lam_max=lmx)
        out.update({f"{kind}/{k_}": v for k_, v in _solve_out(res).items()})
    return out


def case_spectrum(inp, mesh, T):
    """Per-lane intervals: estimated ('lanczos', 'ridge') and explicit.
    The loose Gauss/Lobatto pair is left out: on an estimated interval
    it amplifies the estimate's last bits (1e-12 relative between the
    two packages' eigensolvers on one device)."""
    a, us, _, lmn, lmx = problem(k=16, seed=8)
    op = T.sparse_from_dense(a, device="cpu")
    out = {}
    for spec, k in (("lanczos", 16), ("lanczos", 11), ("ridge", 11)):
        s = T.BIFSolver.create(max_iters=40, rtol=1e-5, spectrum=spec,
                               ridge=1e-3)
        res = s.solve_batch_sharded(op, torch.tensor(us[:k]), mesh=mesh)
        out.update({f"{spec}{k}/{f}": v for f, v in _solve_out(res).items()
                    if f not in LOOSE})
    s = T.BIFSolver.create(max_iters=40, rtol=1e-5)
    lo = np.full(11, lmn) * (1 + 0.001 * np.arange(11))
    res = s.solve_batch_sharded(op, torch.tensor(us[:11]), mesh=mesh,
                                lam_min=torch.tensor(lo),
                                lam_max=torch.tensor(np.full(11, lmx)))
    out.update({f"explicit/{f}": v for f, v in _solve_out(res).items()})
    return out


def case_judges(inp, mesh, T):
    """judge_batch (a knife-edge lane exhausts its cap) and the argmax
    race, plain and with per-lane shift, scale and validity (K = 11)."""
    a, us, true, lmn, lmx = problem(k=5, seed=0)
    s = T.BIFSolver.create(max_iters=12)
    ts = true * np.array([0.5, 0.95, 1.0 + 1e-12, 1.05, 2.0])
    jb = s.judge_batch_sharded(T.sparse_from_dense(a, device="cpu"),
                               torch.tensor(us), torch.tensor(ts),
                               mesh=mesh, lam_min=lmn, lam_max=lmx)
    out = {f"batch/{f}": _np(getattr(jb, f)) for f in jb._fields}
    a, us, true, lmn, lmx = problem(k=16, seed=5)
    op = T.Dense(torch.tensor(a))
    s = T.BIFSolver.create(max_iters=50)
    for what, kw, k in (("argmax", {}, 16), ("argmax_valid", dict(
            shift=torch.tensor(30.0 * np.abs(true[:11])), scale=-1.0,
            valid=torch.tensor(np.arange(11) != int(np.argmax(
                true[:11])))), 11)):
        am = s.judge_argmax_sharded(op, torch.tensor(us[:k]), mesh=mesh,
                                    lam_min=lmn, lam_max=lmx, **kw)
        out.update({f"{what}/{f}": _np(getattr(am, f)) for f in am._fields})
    return out


def case_cadence(inp, mesh, T):
    """decide_every = 4 (and 2): solves, the gathers per round, a resumed
    run, and step_n below one round as a no-op."""
    from repro_torch.core import sharded
    a, us, _, lmn, lmx = problem(k=11, seed=33)
    op = T.sparse_from_dense(a, device="cpu")
    u = torch.tensor(us)
    out = {}
    for r in (2, 4):
        s = T.BIFSolver.create(max_iters=50, rtol=1e-4, decide_every=r)
        res, counts = _counted(lambda: s.solve_batch_sharded(
            op, u, mesh=mesh, lam_min=lmn, lam_max=lmx))
        out.update({f"R{r}/{f}": v for f, v in _solve_out(res).items()})
        out[f"R{r}/counts"] = np.array([counts[k] for k in (
            "gathers", "rounds", "drives", "finalizes", "boundaries")])
        out[f"R{r}/step"] = _np(res.state.step)
        st = sharded.init_state_sharded(s, op, u, mesh=mesh, lam_min=lmn,
                                        lam_max=lmx)
        small = sharded.step_n_sharded(s, st, r - 1, mesh=mesh)
        aligned = [small is st]
        for k in (r, 2 * r + 1):
            st = sharded.step_n_sharded(s, st, k, mesh=mesh)
            aligned.append(int(st.step) % r == 0)
        st = sharded.resume_sharded(s, st, mesh=mesh)
        again = sharded.finalize_sharded(s, st, nlanes=11, mesh=mesh)
        out[f"R{r}/stepped_bit_exact"] = np.array(all(
            torch.equal(getattr(again, f), getattr(res, f))
            for f in ("lower", "upper", "iterations", "certified")))
        out[f"R{r}/aligned"] = np.array(aligned)
    return out


def case_matfun_block(inp, mesh, T):
    """fn = 'log' scalar lanes and block lanes of b = 8, K = 11."""
    a, us, _, lmn, lmx = problem(k=11, seed=21)
    op = T.sparse_from_dense(a, device="cpu")
    s = T.BIFSolver.create(max_iters=50, rtol=1e-6, fn="log")
    out = {f"log/{f}": v for f, v in _solve_out(s.solve_batch_sharded(
        op, torch.tensor(us), mesh=mesh, lam_min=lmn,
        lam_max=lmx)).items()}
    a, _, _, lmn, lmx = problem(n=64, k=11, seed=21)
    op = T.sparse_from_dense(a, device="cpu")
    ub = np.random.default_rng(18).standard_normal((11, 8, a.shape[0]))
    s = T.BIFSolver.create(max_iters=16, rtol=1e-6, block_size=8,
                           decide_every=2)
    res = s.solve_batch_sharded(op, torch.tensor(ub), mesh=mesh, lam_min=lmn,
                                lam_max=lmx)
    out.update({f"block/{f}": v for f, v in _solve_out(res).items()})
    return out


def case_resume(inp, mesh, T):
    """step_n_sharded then resume_sharded against the uninterrupted drive
    (bit for bit), and a per-lane budget lifted, K = 11."""
    from repro_torch.core import sharded
    a, us, _, lmn, lmx = problem(k=11, seed=12)
    s = T.BIFSolver.create(max_iters=50, rtol=1e-4)
    u = torch.tensor(us)
    out = {}
    for kind, op in (("coo", T.sparse_from_dense(a, device="cpu")),
                     ("dense", T.Dense(torch.tensor(a)))):
        whole = s.solve_batch_sharded(op, u, mesh=mesh, lam_min=lmn,
                                      lam_max=lmx)
        st = sharded.init_state_sharded(s, op, u, mesh=mesh, lam_min=lmn,
                                        lam_max=lmx)
        for k in (1, 3):
            st = sharded.step_n_sharded(s, st, k, mesh=mesh)
        st = sharded.resume_sharded(s, st, mesh=mesh)
        got = sharded.finalize_sharded(s, st, nlanes=11, mesh=mesh)
        out.update({f"{kind}/{f}": v for f, v in _solve_out(got).items()})
        out[f"{kind}/bit_exact"] = np.array(all(
            torch.equal(getattr(got, f), getattr(whole, f))
            for f in ("lower", "upper", "gauss_lower", "lobatto_upper",
                      "iterations", "certified")))
        kp = st.st.it.shape[0] * mesh.size()
        st = sharded.init_state_sharded(s, op, u, mesh=mesh, lam_min=lmn,
                                        lam_max=lmx)
        st = sharded.resume_sharded(s, st, it_cap=np.full(kp, 3, np.int32),
                                    mesh=mesh)
        capped = int(sharded.finalize_sharded(
            s, st, nlanes=11, mesh=mesh).iterations.max())
        st = sharded.resume_sharded(s, st, mesh=mesh)
        lifted = sharded.finalize_sharded(s, st, nlanes=11, mesh=mesh)
        out[f"{kind}/budget"] = np.array([capped <= 3, all(
            torch.equal(getattr(lifted, f), getattr(whole, f))
            for f in ("lower", "upper", "iterations"))])
    return out


def _requests_out(reqs) -> dict:
    return {
        "decision": np.array([-1 if r.decision is None else int(r.decision)
                              for r in reqs]),
        "certified": np.array([bool(r.certified) for r in reqs]),
        "resolved": np.array([bool(r.resolved) for r in reqs]),
        "iterations": np.array([r.iterations for r in reqs]),
        "lower": np.array([r.lower for r in reqs]),
        "upper": np.array([r.upper for r in reqs]),
        "banked": np.array([r.state is not None for r in reqs])}


COUNTERS = ("requests.submitted", "requests.resubmitted", "requests.retired",
            "requests.resolved", "requests.partial")


def case_engine(inp, mesh, T):
    """Mixed traffic through BIFEngine(mesh=) (max_batch 6, rounded up to
    the ranks), the budget partial banked and resumed, then the same
    requests without the budget in lockstep mode."""
    from repro_torch.serve import BIFEngine, BIFRequest
    a, lmn, lmx, reqs = inp["engine"]
    op = T.Dense(torch.tensor(a))
    sv = T.BIFSolver.create(max_iters=40, rtol=1e-3)
    eng = BIFEngine(op, solver=sv, max_batch=6, mesh=mesh, lam_min=lmn,
                    lam_max=lmx, chunk_iters=2)
    sub = [eng.submit(BIFRequest(**r)) for r in reqs]
    flushed = eng.flush()
    out = {f"first/{k}": v for k, v in _requests_out(sub).items()}
    out["order"] = np.array([all(x is y for x, y in zip(flushed, sub))])
    partial = [r for r in sub if r.state is not None]
    for r in partial:
        r.max_iters = None
        eng.submit(r)
    eng.flush()
    out.update({f"resumed/{k}": v for k, v in _requests_out(sub).items()})
    stats = eng.stats()
    out["counters"] = np.array([stats["counters"].get(k, 0)
                                for k in COUNTERS])
    out["iteration_hist"] = np.array([stats["histograms"][
        "request.iterations"][f] for f in ("count", "sum", "min", "max")])
    out["max_batch"] = np.array(eng.max_batch)
    lock = BIFEngine(op, solver=sv, max_batch=6, mesh=mesh, lam_min=lmn,
                     lam_max=lmx)
    sub = [lock.submit(BIFRequest(**dict(r, max_iters=None)))
           for r in reqs]
    lock.flush(mode="lockstep")
    out.update({f"lockstep/{k}": v for k, v in _requests_out(sub).items()})
    return out


def case_apps(inp, mesh, T):
    """greedy_map (cold and incremental) and a k-DPP chain on the
    mesh."""
    from repro_torch.core import dpp
    a, lmn, lmx = inp["greedy"]
    n = a.shape[0]
    op = T.Dense(torch.tensor(a))
    out = {}
    for what, kw in (("greedy", {}), ("greedy_incremental",
                                      dict(incremental=True))):
        res = T.greedy_map(op, 6, lmn, lmx, max_iters=n + 2, mesh=mesh, **kw)
        out.update({f"{what}/{f}": _np(getattr(res, f))
                    for f in res._fields})
    draws = inp["kdpp_draws"]
    st = dpp.init_chain(torch.tensor(inp["kdpp_init"]))
    for i in range(len(draws[2])):
        st = dpp.kdpp_step(op, st, lmn, lmx, max_iters=n + 2, mesh=mesh,
                           draws=dpp.KdppDraws(*(torch.tensor(x[i])
                                                 for x in draws)))
    out["kdpp/mask"] = _np(st.mask)
    out.update({f"kdpp/{f}": _np(getattr(st.stats, f))
                for f in st.stats._fields})
    return out


def case_trace(inp, mesh, T):
    """trace_quad(mesh=): 10 Hutchinson probes (the reference's draws,
    replayed) and 16 probes as 4 block lanes of 4."""
    a, _, _, lmn, lmx = problem(k=11, seed=21)
    op = T.sparse_from_dense(a, device="cpu")
    out = {}
    for what, num, kw in (
            ("hutchinson", 10, dict(probes=inp["trace_probes"])),
            ("block", 16, dict(probes=inp["block_probes"], block_size=4))):
        res = T.trace_quad(op, "log", num, lam_min=lmn, lam_max=lmx,
                           mesh=mesh, **kw)
        out[f"{what}/result"] = np.array([
            res.lower, res.upper, res.estimate, res.stat_lower,
            res.stat_upper, res.std_error, res.iterations])
        out[f"{what}/probe_lower"] = res.state.probe_lower
        out[f"{what}/probe_upper"] = res.state.probe_upper
        out[f"{what}/iterations"] = res.state.iterations
    return out


def case_convert(inp, mesh, T):
    """A partial banked by the reference's unit-mesh step_n_sharded
    (K = 12), this rank's shard of it (convert.state_from_numpy(mesh=)),
    resumed to the end."""
    from repro_torch import convert
    from repro_torch.core import sharded
    fields, cfg = inp["banked"]
    s = T.BIFSolver.create(**cfg)
    st = convert.state_from_numpy(fields, device="cpu", mesh=mesh)
    st = sharded.resume_sharded(s, st, mesh=mesh)
    return _solve_out(sharded.finalize_sharded(s, st, mesh=mesh))


def case_kv(inp, mesh, T):
    """rank_blocks(mesh=) against the port's single-device ranking of
    the same keys (the latter is held to the reference by
    tests/test_torch_kv_select.py)."""
    from repro_torch.serve import rank_blocks
    rng = np.random.default_rng(31)
    keys = (rng.standard_normal((6, 16))[rng.integers(0, 6, 40)]
            .repeat(8, 0) + 0.3 * rng.standard_normal((320, 16))
            ).astype(np.float32)
    kw = dict(block=8, max_batch=16, device="cpu")
    order, st = rank_blocks(keys, mesh=mesh, **kw)
    order1, st1 = rank_blocks(keys, **kw)
    b, b1 = np.array(st["brackets"]), np.array(st1["brackets"])
    return {"order_equal": np.array(np.array_equal(order, order1)),
            "max_rel_diff": np.array(np.max(np.abs(b - b1) / np.abs(b1))),
            "uncertified": np.array(st["certified"] != st["blocks"])}


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


def _rank(rank: int, world: int, inputs_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    src = str(Path(__file__).resolve().parent.parent / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch.distributed as dist

    import repro_torch.core as T
    from repro_torch.launch import init_lane_group, make_lane_mesh

    init_lane_group("gloo", rank, world, store=dist.FileStore(
        os.path.join(out_dir, "store"), world), timeout_s=60.0)
    try:
        mesh = make_lane_mesh(device_type="cpu")
        with open(inputs_path, "rb") as f:
            inp = pickle.load(f)
        results, seconds = {}, {}
        for name, fn in CASES.items():
            t0 = time.perf_counter()
            results[name] = fn(inp, mesh, T)
            seconds[name] = time.perf_counter() - t0
        results["_seconds"] = seconds
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _target(rank, world, inputs_path, out_dir):
    try:
        _rank(rank, world, inputs_path, out_dir)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def main(argv) -> int:
    import multiprocessing as mp
    world, inputs_path, out_dir = int(argv[0]), argv[1], argv[2]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_target, args=(r, world, inputs_path,
                                                out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(5.0)
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        print(f"ranks failed: exit codes {codes}"
              f"{' (hung past the join timeout)' if hung else ''}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
