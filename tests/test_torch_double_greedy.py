"""The port's double greedy (core/double_greedy.py, paper Alg. 8 / 9)
against the JAX package on the same seeded numpy inputs (f64): the
reference draws one uniform per item from its key; the test replays them
and feeds them to the port. Selections and quadrature iteration counts
must be equal, ``log_det`` within 1e-12, nothing uncertified."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.data import random_sparse_spd  # noqa: E402

N = 32


def _t(x):
    return torch.as_tensor(np.array(x))


def _uniforms(key, n):
    """The reference's per-item uniforms (double_greedy.py:50, 61)."""
    keys = jax.random.split(key, n)
    return torch.tensor([np.float32(jax.random.uniform(k, (), jnp.float32))
                         for k in keys])


@pytest.fixture(scope="module")
def setup():
    a = random_sparse_spd(N, density=0.2, lam_min=5e-2, seed=9)
    # diagonal near 1, so log-det gains take both signs
    d = np.sqrt(np.diag(a))
    a = a / np.outer(d, d) + 0.05 * np.eye(N)
    w = np.linalg.eigvalsh(a)
    return a, float(w[0] * 0.9), float(w[-1] * 1.1)


@pytest.mark.parametrize("mode", ["batched", "pair", "exact"])
@pytest.mark.parametrize("seed", [0, 1])
def test_double_greedy_matches_reference(setup, seed, mode):
    a, lmn, lmx = setup
    key = jax.random.key(seed)
    kw = dict(max_iters=N + 2, exact=mode == "exact",
              batched=mode != "pair")
    want = R.run_double_greedy(R.Dense(jnp.asarray(a)), key, lmn, lmx, **kw)
    got = T.run_double_greedy(T.Dense(_t(a)), _uniforms(key, N), lmn, lmx,
                              **kw)
    assert got.selected.dtype == torch.float32
    assert np.array_equal(got.selected.numpy(), np.asarray(want.selected))
    assert int(got.quad_iterations) == int(want.quad_iterations)
    assert int(got.uncertified) == int(want.uncertified) == 0
    assert float(got.log_det) == pytest.approx(float(want.log_det),
                                               rel=1e-12)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_double_greedy_on_kernel_backends_matches_reference(setup, backend):
    """K1's plain version on 'pallas' (two lanes a judge), K3's on
    'fused': the selections of the reference backend."""
    a, lmn, lmx = setup
    key = jax.random.key(2)
    want = R.run_double_greedy(R.Dense(jnp.asarray(a)), key, lmn, lmx,
                               max_iters=N + 2)
    got = T.run_double_greedy(
        T.Dense(_t(a)), _uniforms(key, N), lmn, lmx, max_iters=N + 2,
        solver=T.BIFSolver.create(max_iters=N + 2, backend=backend))
    assert np.array_equal(got.selected.numpy(), np.asarray(want.selected))
    assert int(got.uncertified) == 0


def test_double_greedy_takes_a_generator(setup):
    a, lmn, lmx = setup
    op = T.Dense(_t(a))
    by_gen = T.run_double_greedy(op, torch.Generator().manual_seed(3), lmn,
                                 lmx, max_iters=N + 2)
    table = torch.rand(N, generator=torch.Generator().manual_seed(3))
    by_table = T.run_double_greedy(op, table, lmn, lmx, max_iters=N + 2,
                                   exact=True)
    assert torch.equal(by_gen.selected, by_table.selected)
    with pytest.raises(ValueError, match="one per item"):
        T.run_double_greedy(op, table[:-1], lmn, lmx, max_iters=N + 2)
