"""The port's multi-device lanes (core/sharded.py, launch/mesh.py,
sharding/api.py and the ``mesh=`` routes of trace, DPP, the engine and
the rankers) against the JAX package, on the CPU over gloo.

Two layers, as tests/test_sharded.py has:

1. In process, a gloo group of one (a ``FileStore`` in ``tmp_path``):
   the port's unit-world sharded calls against the reference's on its
   unit ``make_lane_mesh(1)``, the lane placement rules, and the errors.
2. One spawn per world size D in {2, 3, 4} (tests/torch_sharded_ranks.py:
   gloo ranks that import no JAX) runs every case of that file; each rank
   returns numpy, and the results are held to the reference's
   single-device results on the same seeded inputs: under jax 0.9.0 the
   reference's own 8-device check fails (ROADMAP.md Queue 3), and its
   contract (repro/core/sharded.py) is that the sharded path returns the
   single-device outcomes.

Tolerances: discrete outcomes (decisions, iterations, certification,
argmax index, selections, masks, counters) equal; floats (brackets,
gains, trace estimates) within 1e-12 relative. Every rank returns the
same bits, and a solve pays exactly one gather per decision round plus
the one before the first round and the finalize gather (rounds + 2)."""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

import repro.core as R  # noqa: E402
import repro.serve as RS  # noqa: E402
from repro.core import dpp as rdpp  # noqa: E402
from repro.core import sharded as rsh  # noqa: E402
from repro.core.trace import _rademacher_probe  # noqa: E402
from repro.launch.mesh import make_lane_mesh as ref_lane_mesh  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import sharded as tsh  # noqa: E402
from repro_torch.launch import init_lane_group, make_lane_mesh  # noqa: E402
from repro_torch.sharding import lane_plan, lane_sharding  # noqa: E402
import torch_sharded_ranks as ranks  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 3, 4)
SPAWN_TIMEOUT_S = ranks.JOIN_TIMEOUT_S + 30.0


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _match(got: dict, want: dict, what: str) -> None:
    """Floats within 1e-12 relative, everything else equal."""
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-12,
                                       err_msg=f"{what}/{k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}/{k}")


def _fields(res, names=None, prefix="") -> dict:
    if names is None:
        names = [f for f in res._fields if f != "state"]
    return {f"{prefix}{f}": _np(getattr(res, f)) for f in names}


SOLVE_FIELDS = ("lower", "upper", "gauss_lower", "lobatto_upper",
                "iterations", "converged", "certified")


@pytest.fixture
def unit_mesh(tmp_path):
    """A gloo group of one in this process and its lane mesh."""
    init_lane_group("gloo", 0, 1, store=dist.FileStore(
        str(tmp_path / "store"), 1), timeout_s=60.0)
    try:
        yield make_lane_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ errors first

def test_make_lane_mesh_without_a_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised default process"):
        make_lane_mesh(device_type="cpu")


def test_nccl_with_more_ranks_than_cards_raises_before_init():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"on {cards} card"):
        init_lane_group("nccl", 0, cards + 1,
                        init_method="tcp://localhost:1")
    assert not dist.is_initialized()


@pytest.mark.parametrize("what", ["reorth_solve", "reorth_init",
                                  "reorth_state", "vector_query",
                                  "block_shape", "world_size", "not_a_mesh",
                                  "swap_block"])
def test_sharded_entry_points_refuse(unit_mesh, what):
    a, us, _, lmn, lmx = ranks.problem(n=16, k=4)
    op, u = T.Dense(_t(a)), _t(us)
    iv = dict(lam_min=lmn, lam_max=lmx)
    s = T.BIFSolver.create(max_iters=8)
    if what == "reorth_solve":
        with pytest.raises(NotImplementedError, match="reorth"):
            s.replace(reorth=True).solve_batch_sharded(op, u, mesh=unit_mesh,
                                                       **iv)
    elif what == "reorth_init":
        with pytest.raises(NotImplementedError, match="reorth"):
            tsh.init_state_sharded(s.replace(reorth=True), op, u,
                                   mesh=unit_mesh, **iv)
    elif what == "reorth_state":
        st = s.replace(reorth=True).init_state(op, u, **iv)
        with pytest.raises(NotImplementedError, match="reorth"):
            tsh.resume_sharded(s, st, mesh=unit_mesh)
    elif what == "vector_query":
        with pytest.raises(ValueError, match=r"\(K, N\) stacked"):
            s.solve_batch_sharded(op, u[0], mesh=unit_mesh, **iv)
    elif what == "block_shape":
        with pytest.raises(ValueError, match="block_size=4"):
            s.replace(block_size=4).judge_batch_sharded(
                op, u.reshape(2, 2, 16), 1.0, mesh=unit_mesh, **iv)
    elif what == "world_size":
        with pytest.raises(ValueError, match="spans the whole group"):
            make_lane_mesh(2, device_type="cpu")
    elif what == "not_a_mesh":
        with pytest.raises(TypeError, match="DeviceMesh"):
            s.solve_batch_sharded(op, u, mesh=object(), **iv)
    else:
        with pytest.raises(NotImplementedError, match="swap-judge"):
            tsh.judge_kdpp_swap_batch_sharded(
                s.replace(block_size=2), op, u[0], u[1], 0.0, 0.5,
                mesh=unit_mesh, **iv)


# ------------------------------------------------------ lane placement rules

def test_lane_specs_shared_vs_stacked():
    a = ranks.make_spd(16, kappa=10.0, seed=0)
    base = T.Dense(_t(a))
    assert T.lane_specs(base) == {"a": "shared"}
    # K == N on purpose: the type decides, not the shape
    specs = T.lane_specs(T.stack_masks(base, torch.ones(16, 16)))
    assert specs == {"mask": "stacked", "base": {"a": "shared"}}
    sop = T.stack_ops([T.sparse_from_dense(a, device="cpu")] * 2)
    assert T.lane_specs(sop)["rows"] == "stacked"
    bop = T.stack_ops([T.bell_from_dense(a, bs=8, device="cpu")] * 2)
    assert T.lane_specs(bop)["data"] == T.lane_specs(bop)["cols"] == \
        "stacked"
    wrapped = T.Shifted(T.Jacobi.create(base), torch.zeros(4))
    specs = T.lane_specs(wrapped)
    assert specs["sigma"] == "stacked"
    assert specs["base"]["inv_sqrt_diag"] == "shared"
    assert specs["base"]["base"] == {"a": "shared"}
    with pytest.raises(ValueError, match="lane dims"):
        T.lane_specs(T.Dense(torch.ones(2, 3, 16, 16)))


def test_pad_lane_op_pads_only_stacked_leaves():
    a = ranks.make_spd(12, kappa=10.0, seed=1)
    mop = T.stack_masks(T.Dense(_t(a)), torch.ones(3, 12))
    padded = tsh._pad_lane_op(mop, 3, 4)
    assert padded.mask.shape == (4, 12) and padded.base.a.shape == (12, 12)
    assert torch.equal(padded.mask[3], torch.zeros(12))
    sop = T.stack_ops([T.sparse_from_dense(a, device="cpu")] * 3)
    padded = tsh._pad_lane_op(sop, 3, 4)
    assert padded.rows.shape[0] == 4 and padded.ell.shape[0] == 4
    assert tsh._pad_lane_op(mop, 3, 3) is mop


def test_lane_plan_and_sharding(unit_mesh):
    from torch.distributed.tensor import Replicate, Shard
    assert lane_plan().rules == {"lanes": "lanes"}
    assert lane_sharding(unit_mesh) == (Shard(0),)
    assert lane_sharding(unit_mesh, ndim=3) == (Shard(0),)
    assert lane_sharding(unit_mesh, plan=lane_plan(None)) == (Replicate(),)
    with pytest.raises(ValueError, match="not an axis"):
        lane_sharding(unit_mesh, plan=lane_plan("rows"))
    mop = T.stack_masks(T.Dense(torch.eye(4)), torch.ones(2, 4))
    assert T.shard_ops(mop, unit_mesh).mask.shape == (2, 4)


# ------------------------------------------- unit world against the reference

def _unit_case(name, a, us, true, lmn, lmx):
    """(the reference's call on its unit mesh, the port's on a gloo group
    of one) for one sharded entry point."""
    iv = dict(lam_min=lmn, lam_max=lmx)
    rs, ts = (R.BIFSolver.create(max_iters=50, rtol=1e-4),
              T.BIFSolver.create(max_iters=50, rtol=1e-4))
    rop, top = R.Dense(jnp.asarray(a)), T.Dense(_t(a))
    ru, tu = jnp.asarray(us), _t(us)
    if name == "solve_batch":
        return (lambda m: rs.solve_batch_sharded(rop, ru, mesh=m, **iv),
                lambda m: ts.solve_batch_sharded(top, tu, mesh=m, **iv))
    if name == "judge_batch":
        thr = true * np.where(np.arange(len(true)) % 2, 0.97, 1.03)
        return (lambda m: rs.judge_batch_sharded(rop, ru, jnp.asarray(thr),
                                                 mesh=m, **iv),
                lambda m: ts.judge_batch_sharded(top, tu, _t(thr), mesh=m,
                                                 **iv))
    if name == "judge_argmax":
        d = 30.0 * np.abs(true)
        return (lambda m: rs.judge_argmax_sharded(
                    rop, ru, shift=jnp.asarray(d), scale=-1.0, mesh=m, **iv),
                lambda m: ts.judge_argmax_sharded(
                    top, tu, shift=_t(d), scale=-1.0, mesh=m, **iv))
    t, p = float(true[1] * 0.8 - true[0]), 0.8
    return (lambda m: rsh.judge_kdpp_swap_batch_sharded(
                rs, rop, ru[0], ru[1], t, p, mesh=m, **iv),
            lambda m: tsh.judge_kdpp_swap_batch_sharded(
                ts, top, tu[0], tu[1], t, p, mesh=m, **iv))


@pytest.mark.parametrize("name", ["solve_batch", "judge_batch",
                                  "judge_argmax", "judge_kdpp_swap_batch"])
def test_unit_world_matches_reference_unit_mesh(unit_mesh, name):
    a, us, true, lmn, lmx = ranks.problem(n=40, k=6, seed=2)
    ref_call, port_call = _unit_case(name, a, us, true, lmn, lmx)
    want = ref_call(ref_lane_mesh(1))
    tsh.reset_counts()
    got = port_call(unit_mesh)
    _match(_fields(got), _fields(want), name)
    c = tsh.COUNTS
    assert c["gathers"] == c["rounds"] + 2 and c["drives"] == 1, c


def test_shard_state_resumes_a_single_device_partial(unit_mesh):
    """A single-device partial is a unit world's shard as it is, and the
    sharded drive resumes it to the single-device endpoint bit for
    bit."""
    a, us, _, lmn, lmx = ranks.problem(n=40, k=6, seed=2)
    s = T.BIFSolver.create(max_iters=50, rtol=1e-4, fn="log")
    op = T.sparse_from_dense(a, device="cpu")
    st = s.step_n(s.init_state(op, _t(us), lam_min=lmn, lam_max=lmx), 3)
    whole = s.finalize(s.resume(st))
    got = tsh.finalize_sharded(s, tsh.resume_sharded(
        s, tsh.shard_state(st, unit_mesh), mesh=unit_mesh), mesh=unit_mesh)
    for f in SOLVE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(whole, f)), f


@pytest.mark.parametrize("route", ["trace_quad", "log_likelihood",
                                   "greedy_map", "kdpp_step", "rank_blocks"])
def test_unit_world_routes_match_one_device(unit_mesh, route):
    """Each ``mesh=`` route at a unit world gives the single-device call's
    bits (the shapes are the same), through the sharded driver."""
    from repro_torch.core import dpp as tdpp
    from repro_torch.serve import rank_blocks
    a, lmn, lmx = ranks.greedy_kernel(n=20)
    op = T.Dense(_t(a))
    mask = torch.zeros(20)
    mask[[1, 4, 9]] = 1.0

    def call(mesh):
        if route == "trace_quad":
            res = T.trace_quad(op, "log", 6, lam_min=lmn, lam_max=lmx,
                               key=3, mesh=mesh)
            return [res.lower, res.upper, res.iterations]
        if route == "log_likelihood":
            res = T.log_likelihood(op, mask, lmn, lmx, mesh=mesh)
            return [res.lower, res.upper, res.iterations]
        if route == "greedy_map":
            res = T.greedy_map(op, 4, lmn, lmx, max_iters=22, mesh=mesh)
            return [res.order, res.gains, res.quad_iterations]
        if route == "kdpp_step":
            draws = tdpp.KdppDraws(torch.linspace(0, 1, 20),
                                   torch.linspace(1, 0, 20), torch.tensor(0.3))
            st = tdpp.kdpp_step(op, tdpp.init_chain(mask), lmn, lmx,
                                draws=draws, max_iters=22, mesh=mesh)
            return [st.mask, *st.stats]
        keys = np.random.default_rng(2).standard_normal((96, 8)).astype(
            np.float32)
        order, info = rank_blocks(keys, block=8, max_batch=4, device="cpu",
                                  mesh=mesh)
        return [order, np.array(info["brackets"])]

    tsh.reset_counts()
    got = call(unit_mesh)
    assert tsh.COUNTS["gathers"] > 0
    for g, w in zip(got, call(None)):
        np.testing.assert_array_equal(_np(g), _np(w))


# --------------------------------------------------------- D ranks, spawned

def _kdpp_draws(key, n, steps):
    """The draws the reference's kdpp_step takes from its key."""
    gv, gu, ps = [], [], []
    for _ in range(steps):
        key, k_v, k_u, k_p = jax.random.split(key, 4)
        gv.append(np.asarray(jax.random.gumbel(k_v, (n,), jnp.float32)))
        gu.append(np.asarray(jax.random.gumbel(k_u, (n,), jnp.float32)))
        ps.append(np.float32(jax.random.uniform(k_p, (), jnp.float32)))
    return np.stack(gv), np.stack(gu), np.array(ps)


def _probes(key, count, n):
    return np.stack([np.asarray(_rademacher_probe(key, i, n, np.float64))
                     for i in range(count)])


KDPP_STEPS, KDPP_KEY, TRACE_KEY, BLOCK_KEY = 6, 105, 3, 13


def _leaves_numpy(x):
    if hasattr(x, "_fields"):
        return {f: _leaves_numpy(v) for f, v in zip(x._fields, x)}
    if dataclasses.is_dataclass(x):
        return {f.name: _leaves_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return None if x is None else np.asarray(x)


CONVERT = dict(max_iters=50, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _banked():
    """A partial of the reference's unit-mesh sharded drive (K = 12,
    fn = 'log', three steps in), its numpy fields, and the reference's
    own resumed result."""
    a, us, _, lmn, lmx = ranks.problem(k=12, seed=40)
    s, mesh = R.BIFSolver.create(**CONVERT), ref_lane_mesh(1)
    st = rsh.step_n_sharded(s, rsh.init_state_sharded(
        s, R.Dense(jnp.asarray(a)), jnp.asarray(us), mesh=mesh,
        lam_min=lmn, lam_max=lmx), 3, mesh=mesh)
    fields = {"op": ("dense", {"a": a}), "st": _leaves_numpy(st.st),
              "lam_min": np.asarray(st.lam_min),
              "lam_max": np.asarray(st.lam_max), "basis": None,
              "step": np.asarray(st.step),
              "coeffs": _leaves_numpy(st.coeffs)}
    done = rsh.finalize_sharded(s, rsh.resume_sharded(s, st, mesh=mesh))
    return fields, _fields(done, SOLVE_FIELDS)


def _inputs() -> dict:
    inp = ranks.build_inputs()
    n = inp["greedy"][0].shape[0]
    init = np.zeros(n, np.float32)
    init[np.random.default_rng(6).choice(n, 5, replace=False)] = 1.0
    inp["kdpp_init"] = init
    inp["kdpp_draws"] = _kdpp_draws(jax.random.key(KDPP_KEY), n, KDPP_STEPS)
    inp["trace_probes"] = _probes(jax.random.key(TRACE_KEY), 10, 48)
    inp["block_probes"] = _probes(jax.random.key(BLOCK_KEY), 16, 48)
    inp["banked"] = (_banked()[0], CONVERT)
    return inp


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawned(D)``: every rank's results of one spawn of D ranks. One
    world runs at a time, each rank on one thread (tier-1 shares the
    machine's cores with other test workers): the first starts when the
    fixture is first used, and runs while the reference computes its
    results; each later one when the one before it is read."""
    root = tmp_path_factory.mktemp("ranks")
    inputs = root / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(_inputs_cache(), f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs, cache = {}, {}

    def start(world):
        if world in procs or world not in WORLDS:
            return
        out = root / f"world{world}"
        out.mkdir()
        procs[world] = (subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_sharded_ranks.py"),
             str(world), str(inputs), str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)

    def run(world):
        if world not in cache:
            start(world)
            proc, out = procs[world]
            try:
                _, err = proc.communicate(timeout=SPAWN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            later = [w for w in WORLDS if w > world]
            if later:
                start(later[0])
            assert proc.returncode == 0, err[-4000:]
            cache[world] = []
            for r in range(world):
                with open(out / f"rank{r}.pkl", "rb") as f:
                    cache[world].append(pickle.load(f))
        return cache[world]

    start(WORLDS[0])
    yield run
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _solve(s, op, us, **kw):
    return _fields(s.solve_batch(op, jnp.asarray(us), **kw), SOLVE_FIELDS)


def _prefixed(prefix, d):
    return {f"{prefix}/{k}": v for k, v in d.items()}


def ref_solve():
    a, us, _, lmn, lmx = ranks.problem()
    s = R.BIFSolver.create(max_iters=50, rtol=1e-4)
    out = {}
    for kind, op in (("dense", R.Dense(jnp.asarray(a))),
                     ("coo", R.sparse_from_dense(a)),
                     ("bell", R.bell_from_dense(a, bs=16))):
        res = s.solve_batch(op, jnp.asarray(us), lam_min=lmn, lam_max=lmx)
        out.update(_prefixed(kind, _fields(res, SOLVE_FIELDS)))
        out[f"{kind}/step"] = np.asarray(res.state.step)
    return out


def ref_padded_masks():
    a, us, _, lmn, lmx = ranks.problem(k=11, seed=3)
    masks = (np.random.default_rng(5).random((11, a.shape[0])) < 0.6
             ).astype(float)
    mop = R.stack_masks(R.Dense(jnp.asarray(a)), jnp.asarray(masks))
    return _solve(R.BIFSolver.create(max_iters=50, rtol=1e-4), mop,
                  us * masks, lam_min=lmn, lam_max=lmx)


def ref_stacked_ops():
    n, k = 32, 8
    mats = [ranks.make_spd(n, kappa=60.0, seed=s) for s in range(k)]
    w = [np.linalg.eigvalsh(m) for m in mats]
    iv = dict(lam_min=min(v[0] for v in w) * 0.99,
              lam_max=max(v[-1] for v in w) * 1.01)
    us = np.random.default_rng(9).standard_normal((k, n))
    s = R.BIFSolver.create(max_iters=n + 2, rtol=1e-4)
    out = {}
    for kind, build in (("coo", R.sparse_from_dense),
                        ("bell", lambda m: R.bell_from_dense(m, bs=16))):
        out.update(_prefixed(kind, _solve(
            s, R.stack_ops([build(m) for m in mats]), us, **iv)))
    return out


def ref_spectrum():
    a, us, _, lmn, lmx = ranks.problem(k=16, seed=8)
    op = R.sparse_from_dense(a)
    out = {}
    for spec, k in (("lanczos", 16), ("lanczos", 11), ("ridge", 11)):
        s = R.BIFSolver.create(max_iters=40, rtol=1e-5, spectrum=spec,
                               ridge=1e-3)
        out.update({k_: v for k_, v in _prefixed(f"{spec}{k}", _solve(
            s, op, us[:k])).items() if k_.split("/")[1] not in ranks.LOOSE})
    lo = np.full(11, lmn) * (1 + 0.001 * np.arange(11))
    out.update(_prefixed("explicit", _solve(
        R.BIFSolver.create(max_iters=40, rtol=1e-5), op, us[:11],
        lam_min=jnp.asarray(lo), lam_max=jnp.full((11,), lmx))))
    return out


def ref_judges():
    a, us, true, lmn, lmx = ranks.problem(k=5, seed=0)
    ts = true * np.array([0.5, 0.95, 1.0 + 1e-12, 1.05, 2.0])
    jb = R.BIFSolver.create(max_iters=12).judge_batch(
        R.sparse_from_dense(a), jnp.asarray(us), jnp.asarray(ts),
        lam_min=lmn, lam_max=lmx)
    out = _fields(jb, prefix="batch/")
    a, us, true, lmn, lmx = ranks.problem(k=16, seed=5)
    op, s = R.Dense(jnp.asarray(a)), R.BIFSolver.create(max_iters=50)
    out.update(_fields(s.judge_argmax(op, jnp.asarray(us), lam_min=lmn,
                                      lam_max=lmx), prefix="argmax/"))
    valid = np.arange(11) != int(np.argmax(true[:11]))
    out.update(_fields(s.judge_argmax(
        op, jnp.asarray(us[:11]), shift=jnp.asarray(30.0 * np.abs(true[:11])),
        scale=-1.0, valid=jnp.asarray(valid), lam_min=lmn, lam_max=lmx),
        prefix="argmax_valid/"))
    return out


def ref_cadence():
    a, us, _, lmn, lmx = ranks.problem(k=11, seed=33)
    out = {}
    for r in (2, 4):
        s = R.BIFSolver.create(max_iters=50, rtol=1e-4, decide_every=r)
        res = s.solve_batch(R.sparse_from_dense(a), jnp.asarray(us),
                            lam_min=lmn, lam_max=lmx)
        out.update(_prefixed(f"R{r}", _fields(res, SOLVE_FIELDS)))
        out[f"R{r}/step"] = np.asarray(res.state.step)
    return out


def ref_matfun_block():
    a, us, _, lmn, lmx = ranks.problem(k=11, seed=21)
    op = R.sparse_from_dense(a)
    out = _prefixed("log", _solve(
        R.BIFSolver.create(max_iters=50, rtol=1e-6, fn="log"), op, us,
        lam_min=lmn, lam_max=lmx))
    a, _, _, lmn, lmx = ranks.problem(n=64, k=11, seed=21)
    op = R.sparse_from_dense(a)
    ub = np.random.default_rng(18).standard_normal((11, 8, a.shape[0]))
    s = R.BIFSolver.create(max_iters=16, rtol=1e-6, block_size=8,
                           decide_every=2)
    out.update(_prefixed("block", _solve(s, op, ub, lam_min=lmn,
                                         lam_max=lmx)))
    return out


def ref_resume():
    a, us, _, lmn, lmx = ranks.problem(k=11, seed=12)
    s = R.BIFSolver.create(max_iters=50, rtol=1e-4)
    out = {}
    for kind, op in (("coo", R.sparse_from_dense(a)),
                     ("dense", R.Dense(jnp.asarray(a)))):
        out.update(_prefixed(kind, _solve(s, op, us, lam_min=lmn,
                                          lam_max=lmx)))
    return out


def ref_engine():
    a, lmn, lmx, reqs = ranks.engine_traffic()
    op = R.Dense(jnp.asarray(a))
    sv = R.BIFSolver.create(max_iters=40, rtol=1e-3)
    eng = RS.BIFEngine(op, solver=sv, max_batch=8, lam_min=lmn, lam_max=lmx,
                       chunk_iters=2)
    sub = [eng.submit(RS.BIFRequest(**r)) for r in reqs]
    eng.flush()
    out = _prefixed("first", ranks._requests_out(sub))
    for r in sub:
        if r.state is not None:
            r.max_iters = None
            eng.submit(r)
    eng.flush()
    out.update(_prefixed("resumed", ranks._requests_out(sub)))
    stats = eng.stats()
    out["counters"] = np.array([stats["counters"].get(k, 0)
                                for k in ranks.COUNTERS])
    out["iteration_hist"] = np.array([stats["histograms"][
        "request.iterations"][f] for f in ("count", "sum", "min", "max")])
    lock = RS.BIFEngine(op, solver=sv, max_batch=8, lam_min=lmn,
                        lam_max=lmx)
    sub = [lock.submit(RS.BIFRequest(**dict(r, max_iters=None)))
           for r in reqs]
    lock.flush(mode="lockstep")
    out.update(_prefixed("lockstep", ranks._requests_out(sub)))
    return out


def ref_apps():
    a, lmn, lmx = ranks.greedy_kernel()
    n = a.shape[0]
    op = R.Dense(jnp.asarray(a))
    out = {}
    for what, kw in (("greedy", {}),
                     ("greedy_incremental", dict(incremental=True))):
        out.update(_fields(R.greedy_map(op, 6, lmn, lmx, max_iters=n + 2,
                                        **kw), prefix=f"{what}/"))
    init = _inputs_cache()["kdpp_init"]
    st = rdpp.run_chain(rdpp.kdpp_step, op, jax.random.key(KDPP_KEY),
                        jnp.asarray(init), KDPP_STEPS, lmn, lmx,
                        max_iters=n + 2)
    out["kdpp/mask"] = np.asarray(st.mask)
    out.update(_fields(st.stats, prefix="kdpp/"))
    return out


def ref_trace():
    a, _, _, lmn, lmx = ranks.problem(k=11, seed=21)
    op = R.sparse_from_dense(a)
    out = {}
    for what, num, kw in (("hutchinson", 10, dict(
            key=jax.random.key(TRACE_KEY))),
            ("block", 16, dict(key=jax.random.key(BLOCK_KEY),
                               block_size=4))):
        res = R.trace_quad(op, "log", num, lam_min=lmn, lam_max=lmx, **kw)
        out[f"{what}/result"] = np.array([
            res.lower, res.upper, res.estimate, res.stat_lower,
            res.stat_upper, res.std_error, res.iterations])
        for f in ("probe_lower", "probe_upper", "iterations"):
            out[f"{what}/{f}"] = np.asarray(getattr(res.state, f))
    return out


def ref_convert():
    return _banked()[1]


def ref_kv():
    # the port against its own single-device ranking (which
    # tests/test_torch_kv_select.py holds to the reference)
    return {"order_equal": np.array(True), "uncertified": np.array(False)}


@functools.lru_cache(maxsize=None)
def _inputs_cache():
    return _inputs()


@functools.lru_cache(maxsize=None)
def _reference(case):
    return globals()[f"ref_{case}"]()


def _check_flags(case, got, world):
    """The port's own invariants of each case."""
    if case == "solve":
        for kind in ("dense", "coo", "bell"):
            gathers, rounds = got[f"{kind}/gathers"]
            assert gathers == rounds + 2, (kind, gathers, rounds)
            assert rounds == int(got[f"{kind}/step"]), kind
    elif case == "cadence":
        for r in (2, 4):
            gathers, rounds, drives, fins, bounds = got[f"R{r}/counts"]
            assert (drives, fins) == (1, 1)
            assert gathers == rounds + 2 and bounds == rounds + 1
            assert int(got[f"R{r}/step"]) == r * rounds
            assert got[f"R{r}/aligned"].all()
            assert bool(got[f"R{r}/stepped_bit_exact"])
    elif case == "resume":
        for kind in ("coo", "dense"):
            assert bool(got[f"{kind}/bit_exact"]), kind
            assert got[f"{kind}/budget"].all(), kind
    elif case == "engine":
        assert int(got["max_batch"]) == -(-6 // world) * world
        assert bool(got["order"])
        assert got["first/banked"].sum() == 1
    elif case == "kv":
        assert float(got["max_rel_diff"]) <= 1e-5


@pytest.mark.parametrize("case", sorted(ranks.CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_match_single_device_reference(spawned, world, case):
    outs = spawned(world)
    got = outs[0][case]
    for r, other in enumerate(outs[1:], 1):
        for k, v in got.items():
            np.testing.assert_array_equal(other[case][k], v,
                                          err_msg=f"rank {r} {case}/{k}")
    _match(got, _reference(case), f"D={world} {case}")
    _check_flags(case, got, world)
