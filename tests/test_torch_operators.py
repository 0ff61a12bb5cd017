"""Operators of the port against the JAX package on the same seeded
numpy inputs (f64): every operator's matvec and diag, the sandwich form
of the fused step, lane stacking, the numpy converters, the device
rules, and the COO matvec's run-to-run determinism."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import convert  # noqa: E402
from conftest import make_spd  # noqa: E402

N = 45


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _pair(kind, a, rng):
    """The same operator in both packages."""
    m = (rng.random(a.shape[-1]) < 0.7).astype(np.float64)
    if kind == "dense":
        return R.Dense(jnp.asarray(a)), T.Dense(_t(a))
    if kind == "coo":
        return (R.sparse_from_dense(a),
                T.sparse_from_dense(a, device="cpu"))
    if kind == "coo_padded":
        nnz = int((a != 0).sum()) + 7
        return (R.sparse_from_dense(a, nnz=nnz),
                T.sparse_from_dense(a, nnz=nnz, device="cpu"))
    if kind == "bell":
        return (R.bell_from_dense(a, bs=8),
                T.bell_from_dense(a, bs=8, device="cpu"))
    if kind == "bell_pallas":
        return (R.bell_from_dense(a, bs=8, dtype=np.float32, mode="pallas",
                                  interpret=True),
                T.bell_from_dense(a, bs=8, dtype=np.float32, mode="pallas",
                                  device="cpu"))
    if kind == "masked":
        return (R.Masked(R.Dense(jnp.asarray(a)), jnp.asarray(m)),
                T.Masked(T.Dense(_t(a)), _t(m)))
    if kind == "shifted":
        return (R.Shifted(R.Dense(jnp.asarray(a)), jnp.asarray(0.75)),
                T.Shifted(T.Dense(_t(a)), _t(0.75)))
    if kind == "jacobi":
        return (R.Jacobi.create(R.Dense(jnp.asarray(a))),
                T.Jacobi.create(T.Dense(_t(a))))
    if kind == "masked_bell":
        return (R.Masked(R.bell_from_dense(a, bs=8), jnp.asarray(m)),
                T.Masked(T.bell_from_dense(a, bs=8, device="cpu"), _t(m)))
    if kind == "matvec_fn":
        d = np.diagonal(a).copy()
        return (R.operators.MatvecFn(lambda x: x @ jnp.asarray(a).T, N,
                                     jnp.asarray(d)),
                T.MatvecFn(lambda x: x @ _t(a).T, N, _t(d)))
    raise AssertionError(kind)


KINDS = ["dense", "coo", "coo_padded", "bell", "bell_pallas", "masked",
         "shifted", "jacobi", "masked_bell", "matvec_fn"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lanes", [(), (3,)])
def test_matvec_and_diag_match_reference(kind, lanes):
    rng = np.random.default_rng(1)
    a = make_spd(N, kappa=80.0, seed=1, density=0.3)
    jop, top = _pair(kind, a, rng)
    x = rng.standard_normal(lanes + (N,))
    want = np.asarray(jop.matvec(jnp.asarray(x)))
    got = top.matvec(_t(x)).numpy()
    tol = 1e-5 if kind == "bell_pallas" else 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(
        want).max())
    assert got.dtype == want.dtype
    np.testing.assert_allclose(top.diag().numpy(), np.asarray(jop.diag()),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["dense", "bell", "masked", "shifted",
                                  "jacobi", "masked_bell"])
def test_fused_operands_match_reference(kind):
    rng = np.random.default_rng(2)
    a = make_spd(N, kappa=80.0, seed=2, density=0.3)
    jop, top = _pair(kind, a, rng)
    jf, tf = R.operators.fused_operands(jop), T.operators.fused_operands(top)
    assert type(tf[0]).__name__ == type(jf[0]).__name__
    for got, want in zip(tf[1:], jf[1:]):
        np.testing.assert_allclose(np.broadcast_to(got.numpy(), (N,)),
                                   np.broadcast_to(np.asarray(want), (N,)),
                                   rtol=1e-15, atol=0)
    x = rng.standard_normal(N)
    base, s_out, s_in, t = tf
    sandwich = s_out * base.matvec(s_in * _t(x)) + t * _t(x)
    np.testing.assert_allclose(sandwich.numpy(), top.matvec(_t(x)).numpy(),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("kind", ["coo", "matvec_fn"])
def test_no_sandwich_form(kind):
    rng = np.random.default_rng(3)
    _, top = _pair(kind, make_spd(N, seed=3), rng)
    assert T.operators.fused_operands(top) is None
    assert T.operators.fused_operands(T.Masked(top, _t(np.ones(N)))) is None


@pytest.mark.parametrize("kind", ["dense", "coo", "bell", "shifted",
                                  "masked"])
def test_stack_ops_matches_reference(kind):
    rng = np.random.default_rng(4)
    mats = [make_spd(N, kappa=50.0, seed=10 + i, density=0.3)
            for i in range(3)]
    pairs = [_pair(kind, a, np.random.default_rng(i))
             for i, a in enumerate(mats)]
    if kind == "coo":  # stacking needs a common nnz capacity
        cap = max(int((a != 0).sum()) for a in mats)
        pairs = [(R.sparse_from_dense(a, nnz=cap),
                  T.sparse_from_dense(a, nnz=cap, device="cpu"))
                 for a in mats]
    jst = R.stack_ops([p[0] for p in pairs])
    tst = T.stack_ops([p[1] for p in pairs])
    x = rng.standard_normal((3, N))
    np.testing.assert_allclose(tst.matvec(_t(x)).numpy(),
                               np.asarray(jst.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)


def test_stack_masks_matches_reference():
    rng = np.random.default_rng(5)
    a = make_spd(N, seed=5)
    masks = (rng.random((4, N)) < 0.6).astype(np.float64)
    jop = R.stack_masks(R.Dense(jnp.asarray(a)), jnp.asarray(masks))
    top = T.stack_masks(T.Dense(_t(a)), [_t(m) for m in masks])
    assert tuple(top.mask.shape) == (4, N)
    x = rng.standard_normal((4, N))
    np.testing.assert_allclose(top.matvec(_t(x)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="wants"):
        T.stack_masks(T.Dense(_t(a)), _t(masks[0]))


def test_configure_backend_rebinds_bell_mode():
    a = make_spd(N, seed=6)
    bell = T.bell_from_dense(a, bs=8, device="cpu")
    op = T.Masked(T.Shifted(bell, _t(0.1)), _t(np.ones(N)))
    pal = T.operators.configure_backend(op, "pallas", None)
    assert pal.base.base.mode == "pallas"
    assert T.operators.configure_backend(pal, "fused", None
                                         ).base.base.mode == "reference"
    dense = T.Dense(_t(a))
    assert T.operators.configure_backend(dense, "pallas", None) is dense


def test_coo_matvec_is_deterministic_and_drops_padding():
    rng = np.random.default_rng(7)
    a = make_spd(N, seed=7, density=0.2)
    op = T.sparse_from_dense(a, nnz=int((a != 0).sum()) + 11, device="cpu")
    x = _t(rng.standard_normal((5, N)))
    y1, y2 = op.matvec(x), op.matvec(x)
    assert torch.equal(y1, y2)
    np.testing.assert_allclose(y1.numpy(), x.numpy() @ a.T, rtol=1e-12,
                               atol=1e-12)
    # lane-stacked pattern with per-lane values
    st = T.stack_ops([op, op])
    np.testing.assert_allclose(st.matvec(x[:2]).numpy(),
                               x[:2].numpy() @ a.T, rtol=1e-12, atol=1e-12)


def _leaves(jop):
    return {f: np.asarray(getattr(jop, f)) for f in
            ("a", "rows", "cols", "vals", "diag_vals", "data", "mask",
             "sigma", "inv_sqrt_diag") if hasattr(jop, f)}


@pytest.mark.parametrize("kind,ckind", [
    ("dense", "dense"), ("coo", "coo"), ("bell", "bell"),
    ("masked", "masked"), ("shifted", "shifted"), ("jacobi", "jacobi")])
def test_operator_from_numpy_round_trips(kind, ckind):
    rng = np.random.default_rng(8)
    a = make_spd(N, seed=8, density=0.3)
    jop, _ = _pair(kind, a, rng)
    leaves = _leaves(jop)
    if hasattr(jop, "n_static"):
        leaves["n_static"] = jop.n_static
    if hasattr(jop, "base"):
        leaves["base"] = ("dense", {"a": np.asarray(jop.base.a)})
    top = convert.operator_from_numpy(ckind, leaves, device="cpu")
    x = rng.standard_normal((2, N))
    np.testing.assert_allclose(top.matvec(_t(x)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)


def _state_dict(st):
    return {f: (_state_dict(v) if hasattr(v, "_fields") else np.asarray(v))
            for f, v in zip(st._fields, st)}


def test_state_from_numpy_builds_each_state():
    rng = np.random.default_rng(9)
    a = make_spd(N, seed=9)
    us = rng.standard_normal((3, N))
    jst = R.gql.gql_init(R.Dense(jnp.asarray(a)), jnp.asarray(us), 0.005,
                         2.0)
    d = _state_dict(jst)
    gst = convert.state_from_numpy(d, device="cpu")
    assert isinstance(gst, T.gql.GQLState)
    assert isinstance(gst.lz, T.lanczos.LanczosState)
    assert gst.lz.live.dtype == torch.bool and gst.it.dtype == torch.int32
    for f in gst._fields:
        if f != "lz":
            np.testing.assert_array_equal(getattr(gst, f).numpy(), d[f])
    lz = convert.state_from_numpy(d["lz"], device="cpu")
    np.testing.assert_array_equal(lz.v.numpy(), d["lz"]["v"])
    q = convert.state_from_numpy(
        {"op": ("dense", {"a": a}), "st": d, "lam_min": np.asarray(0.005),
         "lam_max": np.asarray(2.0), "basis": None,
         "step": np.asarray(0, np.int32)}, device="cpu")
    assert isinstance(q, T.QuadState) and q.basis is None
    with pytest.raises(ValueError, match="match no"):
        convert.state_from_numpy({"g": np.zeros(3)}, device="cpu")


def test_cuda_device_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    a = make_spd(16, seed=10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.bell_from_dense(a, bs=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.sparse_from_dense(a)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.operator_from_numpy("dense", {"a": a})


def test_bell_interpret_true_refused_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = make_spd(16, seed=11)
    op = T.bell_from_dense(a, bs=8, dtype=np.float32, mode="pallas",
                           interpret=True, device="cuda")
    with pytest.raises(ValueError, match="interpret"):
        op.matvec(torch.ones(16, dtype=torch.float64, device="cuda"))
