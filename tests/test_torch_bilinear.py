"""K6 ``fused_matvec``: its plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) and its ``ref`` oracle, on the
same seeded numpy inputs, and the path that runs it: a ``MatvecFn``
operator over ``fused_matvec`` driving ``solve_batch`` / ``judge_batch``
over independent systems, in both packages, on 'reference' and 'pallas'.

Tolerances: the JAX kernel test's (tests/test_kernels.py:19-25), 1e-5
for f32 A and 3e-2 for bf16 A, on y, and five times that on alpha. On
the path the matvec is f32 (the kernel's contract) and the Lanczos
vectors f64, so the two packages' brackets differ by f32 rounding order:
they agree to 1e-5 relative, and each holds the dense-solve truth of the
f32 operator within kappa * 2^-24 (kappa of the spectral interval), the
slack chip_smoke.py allows an f32 matvec. The CUDA kernel has no CPU
mode: tests/test_torch_cuda.py and chip_smoke.py hold it to this plain
version on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import BIFSolver as JSolver  # noqa: E402
from repro.core import Dense as JDense  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import bilinear_matvec as tbm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _sym(b, n, seed):
    """Seeded symmetric (b, n, n) f32 blocks and (b, n) f32 vectors, as
    the JAX kernel test draws them."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, n))
    a = ((a + np.swapaxes(a, -1, -2)) / 2).astype(np.float32)
    x = rng.standard_normal((b, n)).astype(np.float32)
    return a, x


@pytest.mark.parametrize("b,n", [(1, 64), (3, 100), (2, 256), (4, 130),
                                 (1, 384)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k6_plain_matches_pallas_and_ref(b, n, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    a, x = _sym(b, n, n + b)
    # both packages round the same f32 values to bf16 (nearest even)
    ja, ta = jnp.asarray(a, jdt), torch.as_tensor(a).to(tdt)
    np.testing.assert_array_equal(np.asarray(ja, np.float32),
                                  ta.to(torch.float32).numpy())
    y, al = tops.fused_matvec(ta, torch.as_tensor(x))
    assert y.dtype == al.dtype == torch.float32
    assert tuple(y.shape) == (b, n) and tuple(al.shape) == (b,)
    for yw, alw in (jkops.fused_matvec(ja, jnp.asarray(x), interpret=True),
                    jref.fused_matvec(ja, jnp.asarray(x))):
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), rtol=tol,
                                   atol=tol * 10)
        np.testing.assert_allclose(al.numpy(), np.asarray(alw),
                                   rtol=tol * 5, atol=tol * 100)


def test_k6_rejects_other_system_counts():
    """The reference sizes its grid by a.shape[0] alone: with a (1, N, N)
    and x (3, N) it returns y (1, N), silently (ROADMAP Queue 3). The
    port raises."""
    a, x = _sym(1, 64, 0)
    _, x3 = _sym(3, 64, 1)
    y_ref, _ = jkops.fused_matvec(jnp.asarray(a), jnp.asarray(x3),
                                  interpret=True)
    assert y_ref.shape == (1, 64)  # the reference's fault, as logged
    for bad in (torch.as_tensor(x3), torch.as_tensor(x[0]),
                torch.as_tensor(x3[:, :32])):
        with pytest.raises(ValueError, match="fused_matvec wants x"):
            tops.fused_matvec(torch.as_tensor(a), bad)
    with pytest.raises(ValueError, match="fused_matvec wants a"):
        tops.fused_matvec(torch.as_tensor(a[0]), torch.as_tensor(x))


def test_k6_cuda_launcher_refuses_cpu_tensors():
    a, x = _sym(2, 32, 3)
    before = tops.LAUNCHES["fused_matvec"]
    tops.fused_matvec(torch.as_tensor(a), torch.as_tensor(x))
    assert tops.LAUNCHES["fused_matvec"] == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        tbm.fused_matvec_cuda(torch.as_tensor(a), torch.as_tensor(x))


# ---------------------------------------------------------------------------
# The K6 path: MatvecFn over fused_matvec in the batched solver


def _systems(b, n, seed):
    """``b`` SPD systems A_k = K + lam_k I (one seeded SPD K with
    geometric eigenvalues, a ridge sweep lam_k), stored in f32 as the
    kernel takes them; the exact f64 values of the f32 entries; seeded
    f64 queries; per-lane spectral intervals of the f32 operators."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    k = (q * np.geomspace(0.01, 1.0, n)) @ q.T
    lam = 0.02 * 2.0 ** (np.arange(b) / 2)
    a32 = (k[None] + lam[:, None, None] * np.eye(n)).astype(np.float32)
    a64 = a32.astype(np.float64)
    w = np.linalg.eigvalsh(a64)
    u = rng.standard_normal((b, n))
    return a32, a64, u, 0.9 * w[:, 0], 1.1 * w[:, -1]


def _jax_op(a32):
    ab = jnp.asarray(a32)
    return jops.MatvecFn(
        fn=lambda x: jkops.fused_matvec(ab, x, interpret=True)[0],
        n_static=a32.shape[-1],
        diag_vals=jnp.asarray(np.diagonal(a32, axis1=1, axis2=2)))


def _torch_op(a32):
    ta = torch.as_tensor(a32)
    return repro_torch.MatvecFn(
        fn=lambda x: tops.fused_matvec(ta, x)[0], n_static=a32.shape[-1],
        diag_vals=torch.as_tensor(np.diagonal(a32, axis1=1, axis2=2).copy()))


@pytest.mark.parametrize("n", [130, 256])
@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("call", ["solve_batch", "judge_batch"])
def test_k6_path_matches_reference(n, backend, call):
    b = 4
    a32, a64, u, lmn, lmx = _systems(b, n, seed=n)
    truth = np.einsum("bi,bi->b", u, np.linalg.solve(a64, u[..., None])[..., 0])
    t = truth * np.array([0.9, 1.1, 0.97, 1.03])
    cfg = dict(max_iters=80, rtol=1e-4, backend=backend)
    jsol, tsol = JSolver.create(**cfg), repro_torch.BIFSolver.create(**cfg)
    iv = dict(lam_min=lmn, lam_max=lmx)
    tiv = {k: torch.as_tensor(v) for k, v in iv.items()}
    if call == "solve_batch":
        jr = jsol.solve_batch(_jax_op(a32), jnp.asarray(u), **iv)
        tr = tsol.solve_batch(_torch_op(a32), torch.as_tensor(u), **tiv)
    else:
        jr = jsol.judge_batch(_jax_op(a32), jnp.asarray(u), jnp.asarray(t),
                              **iv)
        tr = tsol.judge_batch(_torch_op(a32), torch.as_tensor(u),
                              torch.as_tensor(t), **tiv)
        np.testing.assert_array_equal(tr.decision.numpy(),
                                      np.asarray(jr.decision))
        assert np.array_equal(tr.decision.numpy(), t < truth)
    np.testing.assert_array_equal(tr.iterations.numpy(),
                                  np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.certified.numpy(),
                                  np.asarray(jr.certified))
    assert tr.certified.all()
    if call == "judge_batch":
        return
    lo, hi = tr.lower.numpy(), tr.upper.numpy()
    assert lo.dtype == np.float64  # f32 matvec results promote to f64
    np.testing.assert_allclose(lo, np.asarray(jr.lower), rtol=1e-5)
    np.testing.assert_allclose(hi, np.asarray(jr.upper), rtol=1e-5)
    slack = (lmx / lmn) * 2.0 ** -24 * np.abs(truth)
    assert np.all(lo <= truth + slack) and np.all(hi >= truth - slack)


def test_dense_f32_matrices_with_f64_queries_promote_like_the_reference():
    """An f32 Dense operator against f64 queries computes in f64, as the
    reference's jnp.einsum does (torch.einsum alone refuses mixed float
    types): the 'reference' side of the K6 path in chip_smoke.py."""
    a32, a64, u, lmn, lmx = _systems(4, 130, seed=7)
    cfg = dict(max_iters=80, rtol=1e-6)
    jr = JSolver.create(**cfg).solve_batch(JDense(jnp.asarray(a32)),
                                           jnp.asarray(u), lam_min=lmn,
                                           lam_max=lmx)
    tr = repro_torch.BIFSolver.create(**cfg).solve_batch(
        repro_torch.Dense(torch.as_tensor(a32)), torch.as_tensor(u),
        lam_min=torch.as_tensor(lmn), lam_max=torch.as_tensor(lmx))
    assert tr.lower.dtype == torch.float64
    np.testing.assert_array_equal(tr.iterations.numpy(),
                                  np.asarray(jr.iterations))
    np.testing.assert_allclose(tr.lower.numpy(), np.asarray(jr.lower),
                               rtol=1e-12)
    np.testing.assert_allclose(tr.upper.numpy(), np.asarray(jr.upper),
                               rtol=1e-12)
    truth = np.einsum("bi,bi->b", u,
                      np.linalg.solve(a64, u[..., None])[..., 0])
    assert np.all(tr.lower.numpy() <= truth * (1 + 1e-9))
    assert np.all(tr.upper.numpy() >= truth * (1 - 1e-9))
