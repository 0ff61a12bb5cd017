"""The port's stochastic trace estimation (``repro_torch.core.trace``:
``trace_quad``, ``logdet_quad``) against the JAX package, and the slice
as a whole: block-Krylov Hutchinson logdet on a blocked-ELL operator
through K5's plain version.

The reference draws its Rademacher probes with ``jax.random``; torch
cannot reproduce that stream, so the parity tests replay the reference's
draws into the port (``probes=``). The port's own keyed stream is held
to the extend/resume invariants inside the port.

Tolerances: per-lane iterations exactly equal; brackets, estimates and
standard errors within 1e-12 relative on the f64 paths and 1e-5 where a
blocked-ELL product runs in f32 (``backend='pallas'``); exact-mode
brackets contain the dense-eigh trace (slack 1e-8 relative); Hutchinson
brackets contain the probe-sample mean. Resumed and chunked runs inside
the port are bit-exact with direct runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.trace import _rademacher_probe  # noqa: E402
from repro_torch.core import trace as ttr  # noqa: E402
from conftest import make_spd  # noqa: E402

_F = {"log": np.log, "invsqrt": lambda x: x ** -0.5,
      "inv": lambda x: 1.0 / x, "sqrt": np.sqrt}


def _t(x):
    return torch.as_tensor(np.array(x))


def _problem(n=24, kappa=50.0, seed=0):
    a = make_spd(n, kappa=kappa, seed=seed)
    w, v = np.linalg.eigh(a)
    return a, w, v, float(w[0] * 0.99), float(w[-1] * 1.01)


def _ops(kind, a):
    if kind == "dense":
        return R.Dense(jnp.asarray(a)), T.Dense(_t(a))
    if kind == "coo":
        return R.sparse_from_dense(a), T.sparse_from_dense(a, device="cpu")
    raise AssertionError(kind)


def _jax_probes(key, count, n):
    return np.stack([np.asarray(_rademacher_probe(key, i, n, np.float64))
                     for i in range(count)])


def _same_result(got, want, rtol, what):
    np.testing.assert_array_equal(got.state.iterations,
                                  np.asarray(want.state.iterations), what)
    assert got.iterations == want.iterations and \
        got.num_probes == want.num_probes
    for f in ("lower", "upper", "estimate", "stat_lower", "stat_upper",
              "std_error"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=rtol, atol=rtol,
                                   err_msg=f"{what}.{f}")
    for f in ("probe_lower", "probe_upper"):
        np.testing.assert_allclose(getattr(got.state, f),
                                   np.asarray(getattr(want.state, f)),
                                   rtol=rtol, err_msg=f"{what}.{f}")


@pytest.mark.parametrize("fn", ["log", "invsqrt", "inv", "sqrt"])
@pytest.mark.parametrize("kind", ["dense", "coo"])
def test_exact_probes_match_reference_and_bracket_trace(fn, kind):
    a, w, _, lmn, lmx = _problem()
    jop, top = _ops(kind, a)
    want = R.trace_quad(jop, fn, None, lam_min=lmn, lam_max=lmx)
    got = T.trace_quad(top, fn, None, lam_min=lmn, lam_max=lmx)
    _same_result(got, want, 1e-12, f"{fn}/{kind}")
    true = float(np.sum(_F[fn](w)))
    scale = max(abs(true), 1.0)
    assert got.lower <= true + 1e-8 * scale
    assert got.upper >= true - 1e-8 * scale
    assert got.std_error == 0.0
    assert (got.stat_lower, got.stat_upper) == (got.lower, got.upper)
    assert got.num_probes == a.shape[0]


@pytest.mark.parametrize("block_size", [1, 4])
def test_hutchinson_with_replayed_probes_matches_reference(block_size):
    a, w, v, lmn, lmx = _problem(seed=3)
    n = a.shape[0]
    key = jax.random.key(7)
    kw = dict(lam_min=lmn, lam_max=lmx, block_size=block_size)
    want = R.trace_quad(R.Dense(jnp.asarray(a)), "log", 8, key=key, **kw)
    zs = _jax_probes(key, 8, n)
    got = T.trace_quad(T.Dense(_t(a)), "log", 8, probes=zs, **kw)
    _same_result(got, want, 1e-12, f"b={block_size}")
    vals = np.sum((zs @ v) ** 2 * np.log(w), axis=-1)
    tol = 1e-12 * abs(vals.mean())
    assert got.lower - tol <= vals.mean() <= got.upper + tol
    lanes = vals.reshape(-1, block_size).sum(axis=-1)
    assert np.all(got.state.probe_lower <= lanes + 1e-9 * np.abs(lanes))
    assert np.all(got.state.probe_upper >= lanes - 1e-9 * np.abs(lanes))
    assert got.std_error > 0.0
    if block_size == 1:     # the reference's own CI check (8 lanes)
        true = float(np.sum(np.log(w)))
        assert got.stat_lower <= true <= got.stat_upper


def test_block_logdet_on_bell_pallas_matches_reference():
    """The slice as a whole at a small size: block-Krylov Hutchinson
    logdet of a blocked-ELL operator with f32 blocks on 'pallas' (the
    SpMM on K5's plain version in the port, the Pallas kernel in
    interpret mode in the reference), f64 probes replayed from the
    reference's key; and the same on the f64 'reference' backend."""
    n, bs, p, b = 96, 16, 16, 4
    a = make_spd(n, kappa=60.0, seed=21, density=0.08)
    a32 = a.astype(np.float32).astype(np.float64)
    w, v = np.linalg.eigh(a32)
    lmn, lmx = float(w[0] * 0.95), float(w[-1] * 1.05)
    key = jax.random.key(3)
    zs = _jax_probes(key, p, n)
    jop = R.bell_from_dense(a, bs=bs, dtype=np.float32)
    # the f32 blocks with an f64 diagonal: probes and Krylov vectors f64
    jop = dataclasses.replace(jop, diag_vals=jnp.asarray(np.diag(a32)))
    top = T.bell_from_dense(a, bs=bs, dtype=np.float32, device="cpu")
    top = dataclasses.replace(top, diag_vals=_t(np.diag(a32)))
    vals = np.sum((zs @ v) ** 2 * np.log(w), axis=-1).reshape(-1, b).sum(-1)
    for backend, rtol in (("pallas", 1e-5), ("reference", 1e-12)):
        kw = dict(max_iters=24, rtol=1e-6, backend=backend)
        want = R.logdet_quad(jop, p, lam_min=lmn, lam_max=lmx, key=key,
                             block_size=b, solver=R.BIFSolver.create(
                                 pallas_interpret=True, **kw))
        got = T.logdet_quad(top, p, lam_min=lmn, lam_max=lmx, probes=zs,
                            block_size=b, solver=T.BIFSolver.create(**kw))
        _same_result(got, want, rtol, backend)
        slack = 1e-5 if backend == "pallas" else 1e-8
        assert np.all(got.state.probe_lower <= vals + slack * np.abs(vals))
        assert np.all(got.state.probe_upper >= vals - slack * np.abs(vals))
        assert np.all(got.state.iterations < 24)


def test_probe_stream_extends_and_resumes_bit_exact():
    """The port's keyed stream: extending a banked state adds the probes
    a direct run draws (scalar and block lanes), chunked walks bank the
    same brackets, and the resume guards reject mismatched resumes."""
    a, w, _, lmn, lmx = _problem(seed=5)
    op = T.sparse_from_dense(a, device="cpu")
    iv = dict(lam_min=lmn, lam_max=lmx)
    for b in (1, 4):
        kw = dict(key=11, block_size=b, **iv)
        r8 = T.trace_quad(op, "log", 8, **kw)
        assert len(r8.state.probe_lower) == 8 // b
        r16 = T.trace_quad(op, "log", 16, state=r8.state, **kw)
        direct = T.trace_quad(op, "log", 16, **kw)
        assert (r16.lower, r16.upper, r16.estimate, r16.std_error) == \
            (direct.lower, direct.upper, direct.estimate, direct.std_error)
        assert r16.iterations == direct.iterations
        np.testing.assert_array_equal(r16.state.probe_lower,
                                      direct.state.probe_lower)
        np.testing.assert_array_equal(r16.state.probe_upper,
                                      direct.state.probe_upper)
        chunked = T.trace_quad(op, "log", 16, probe_chunk=6, **kw)
        np.testing.assert_array_equal(chunked.state.probe_lower,
                                      direct.state.probe_lower)
        true = float(np.sum(np.log(w)))
        assert direct.stat_lower - 5 * direct.std_error <= true
        assert true <= direct.stat_upper + 5 * direct.std_error
    # explicit probes extend the same way
    zs = torch.stack([ttr.rademacher_probe(11, i, a.shape[0])
                      for i in range(16)])
    e8 = T.trace_quad(op, "log", 8, probes=zs[:8], **iv)
    e16 = T.trace_quad(op, "log", 16, probes=zs, state=e8.state, **iv)
    keyed = T.trace_quad(op, "log", 16, key=11, **iv)
    np.testing.assert_array_equal(e16.state.probe_lower,
                                  keyed.state.probe_lower)
    # guards
    r8 = T.trace_quad(op, "log", 8, key=11, **iv)
    with pytest.raises(ValueError, match="resume state banks"):
        T.trace_quad(op, "invsqrt", 16, key=11, state=r8.state, **iv)
    with pytest.raises(ValueError, match="can only extend"):
        T.trace_quad(op, "log", 4, key=11, state=r8.state, **iv)
    with pytest.raises(ValueError, match="num_probes"):
        T.trace_quad(op, "log", 0, **iv)
    with pytest.raises(ValueError, match="different key"):
        T.trace_quad(op, "log", 16, key=99, state=r8.state, **iv)
    with pytest.raises(ValueError, match="different key"):
        T.trace_quad(op, "log", 16, probes=-zs, state=r8.state, **iv)
    with pytest.raises(ValueError, match="spectral interval"):
        T.trace_quad(op, "log", 16, key=11, state=r8.state,
                     lam_min=lmn * 0.5, lam_max=lmx)
    with pytest.raises(ValueError, match="multiple of block_size"):
        T.trace_quad(op, "log", 10, key=11, block_size=4, **iv)
    with pytest.raises(ValueError, match="banks block_size"):
        T.trace_quad(op, "log", 16, key=11, block_size=2, state=r8.state,
                     **iv)
    with pytest.raises(ValueError, match="probes must be"):
        T.trace_quad(op, "log", 32, probes=zs, **iv)
    with pytest.raises(TypeError, match="DeviceMesh"):
        T.trace_quad(op, "log", 8, mesh=object(), **iv)


def test_rademacher_stream_is_keyed_by_index():
    z = ttr.rademacher_probe(4, 2, 64)
    assert z.dtype == torch.float64 and set(z.tolist()) <= {-1.0, 1.0}
    assert torch.equal(z, ttr.rademacher_probe(4, 2, 64))
    assert not torch.equal(z, ttr.rademacher_probe(4, 3, 64))
    assert not torch.equal(z, ttr.rademacher_probe(5, 2, 64))


def test_block_exact_mode_pads_and_matches_reference():
    """Exact unit-probe mode with b = 7 on N = 24: the last block
    zero-pads, its pad slots deflate, the summed bracket certifies the
    true trace and equals the reference's."""
    a, w, _, lmn, lmx = _problem(seed=2)
    want = R.trace_quad(R.Dense(jnp.asarray(a)), "log", None, lam_min=lmn,
                        lam_max=lmx, block_size=7)
    got = T.trace_quad(T.Dense(_t(a)), "log", None, lam_min=lmn,
                       lam_max=lmx, block_size=7)
    _same_result(got, want, 1e-12, "exact b=7")
    true = float(np.sum(np.log(w)))
    scale = max(abs(true), 1.0)
    assert got.lower <= true + 1e-8 * scale
    assert got.upper >= true - 1e-8 * scale
    assert len(got.state.probe_lower) == 4


def test_logdet_quad_masked_needs_no_correction():
    a, _, _, lmn, lmx = _problem(seed=13, kappa=20.0)
    n = a.shape[0]
    mask = (np.random.default_rng(2).random(n) < 0.5).astype(float)
    idx = np.where(mask > 0.5)[0]
    true = float(np.linalg.slogdet(a[np.ix_(idx, idx)])[1])
    iv = dict(lam_min=min(lmn, 1.0), lam_max=max(lmx, 1.0))
    got = T.logdet_quad(T.Masked(T.Dense(_t(a)), _t(mask)), None, **iv)
    want = R.logdet_quad(R.Masked(R.Dense(jnp.asarray(a)),
                                  jnp.asarray(mask)), None, **iv)
    _same_result(got, want, 1e-12, "masked")
    assert got.lower <= true <= got.upper
    assert got.upper - got.lower <= 1e-3 * max(abs(true), 1.0)
