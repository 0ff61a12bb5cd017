"""K1-K4: each kernel's plain PyTorch version against the JAX package's
Pallas kernel in interpret mode, on the same seeded numpy inputs (f64,
small sizes, ragged lane counts and lengths, breakdown lanes included),
plus the dispatch layer's device routing.

Tolerances: 1e-12 relative for the f64 kernels (summation order; the
reference's own gemm contract, test_fused_step.py), 1e-5 for the BELL
SpMV, whose contract is f32 accumulation. The CUDA kernels themselves
have no CPU mode: ``tests/test_torch_cuda.py`` holds them to these plain
versions on a card, and so does ``python3 chip_smoke.py`` at the main
path's shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import gql_update as jgu  # noqa: E402
from repro.kernels import lanczos_step as jls  # noqa: E402
from repro.kernels import spmv_bell as jsb  # noqa: E402
from repro_torch.kernels import bilinear_matvec as tbm  # noqa: E402
from repro_torch.kernels import gql_update as tgu  # noqa: E402
from repro_torch.kernels import lanczos_step as tls  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spmv_bell as tsb  # noqa: E402
from conftest import make_spd  # noqa: E402

RTOL = 1e-12


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, rtol=RTOL, what="", floor=0.0):
    """Each output within ``rtol`` of its own largest entry, or of
    ``floor`` (1 for the fused steps, whose vectors are unit-normalized:
    the reference's rtol = atol = 1e-12 contract, test_fused_step.py)."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(np.nanmax(np.abs(np.where(np.isfinite(w), w, 0.0))),
                    floor, 1e-300)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale,
                                   equal_nan=True, err_msg=f"{what}[{i}]")


def _recurrence_inputs(b, seed, guards=True):
    """Ten (B,) operands of one recurrence step; with ``guards``, lanes
    that hit the guards: a zero beta_p, a zero pivot, and pivots of the
    wrong sign. (Those lanes' outputs are ill-conditioned, so the fused
    steps, whose alpha/beta differ in the last bits by summation order,
    take only the breakdown lane.)"""
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.5, 3.0, b)
    beta_n = rng.uniform(0.0, 1.0, b)
    beta_p = rng.uniform(0.0, 1.0, b)
    g = rng.uniform(0.1, 2.0, b)
    c = rng.uniform(-1.0, 1.0, b)
    delta = rng.uniform(0.2, 2.0, b)
    lam_min = np.full(b, 0.05)
    lam_max = np.full(b, 4.0)
    d_lr = delta - 0.05 + rng.uniform(0.0, 0.5, b)
    d_rr = delta - 4.0 - rng.uniform(0.0, 0.5, b)
    beta_n[0] = 0.0          # breakdown: Krylov space exhausted
    if not guards:
        return [alpha, beta_n, beta_p, g, c, delta, d_lr, d_rr, lam_min,
                lam_max]
    beta_p[1] = 0.0
    delta[2] = 0.0           # guard: zero pivot
    d_lr[3] = -0.1           # guard: wrong-sign pivots
    d_rr[3] = 0.2
    return [alpha, beta_n, beta_p, g, c, delta, d_lr, d_rr, lam_min, lam_max]


@pytest.mark.parametrize("b", [1, 7, 33])
def test_k1_gql_update_plain_matches_pallas(b):
    ins = _recurrence_inputs(max(b, 4), seed=b)[:]
    ins = [x[:b] for x in ins]
    want = jgu.gql_update(*[jnp.asarray(x) for x in ins], interpret=True)
    got = tgu.gql_update_plain(*[_t(x) for x in ins])
    _close(got, want, what="gql_update")
    got_ops = ops.gql_update(*[_t(x) for x in ins])
    for g, o in zip(got, got_ops):
        assert torch.equal(g, o)


def test_k1_scalar_interval_broadcasts():
    ins = _recurrence_inputs(6, seed=3)
    lmn, lmx = 0.05, 4.0
    want = jgu.gql_update(*[jnp.asarray(x) for x in ins[:8]], lmn, lmx,
                          interpret=True)
    got = tgu.gql_update_plain(*[_t(x) for x in ins[:8]], lmn, lmx)
    _close(got, want, what="gql_update scalar interval")


@pytest.mark.parametrize("form", ["0-d", "(1,)", "stride-0", "strided"])
def test_k1_operands_are_read_in_place(form):
    """K1 reads each operand as a pointer and a lane stride: a 0-d or
    (1,) value and a stride-0 expand are read at stride 0, a strided view
    at its stride; nothing is copied, and the results equal those of the
    materialised operands, bit for bit."""
    b = 9
    ins = [_t(x) for x in _recurrence_inputs(b, seed=5)]
    ins[8], ins[9] = torch.full((b,), 0.05, dtype=torch.float64), \
        torch.full((b,), 4.0, dtype=torch.float64)
    want = tgu.gql_update_plain(*ins)
    if form == "strided":
        buf = [torch.stack([x, -x], 1) for x in ins]
        args = [x[:, 0] for x in buf]
        assert all(x.stride(0) == 2 for x in args)
    else:
        scalar = {"0-d": lambda v: torch.tensor(v, dtype=torch.float64),
                  "(1,)": lambda v: torch.tensor([v], dtype=torch.float64),
                  "stride-0": lambda v: torch.tensor(
                      v, dtype=torch.float64).expand(b)}[form]
        args = ins[:8] + [scalar(0.05), scalar(4.0)]
    b_read, operands = tgu.lane_operands(args)
    assert b_read == b
    for (x, stride), arg in zip(operands, args):
        assert x is arg
        if form == "strided":
            assert stride == 2
    assert [s for _, s in operands[8:]] == ([2, 2] if form == "strided"
                                            else [0, 0])
    for got in (tgu.gql_update_plain(*args), ops.gql_update(*args)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_k1_operand_errors():
    ins = [_t(x) for x in _recurrence_inputs(6, seed=2)]
    with pytest.raises(ValueError, match="flat"):      # g sets the lanes
        ops.gql_update(*ins[:3], ins[3][None], *ins[4:])
    with pytest.raises(ValueError, match="shape"):     # another lane count
        ops.gql_update(ins[0][:5], *ins[1:])
    with pytest.raises(ValueError, match="float32"):   # another dtype
        ops.gql_update(ins[0].float(), *ins[1:])
    with pytest.raises(ValueError, match="meta"):      # another device
        ops.gql_update(*ins[:9], torch.zeros(6, dtype=torch.float64,
                                              device="meta"))


@pytest.mark.parametrize("n,bs,lanes", [(64, 8, 1), (100, 8, 3),
                                        (37, 8, 2)])
def test_k2_bell_matvec_plain_matches_pallas(n, bs, lanes):
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    a = (m + m.T) / 2
    data, cols, _ = tsb.dense_to_bell(a, bs=bs)
    jdata, jcols, _ = jsb.dense_to_bell(a, bs=bs)
    np.testing.assert_array_equal(data, np.asarray(jdata))
    np.testing.assert_array_equal(cols, np.asarray(jcols))
    npad = data.shape[0] * bs
    x = rng.standard_normal((lanes, npad)).astype(np.float32)
    want = [jsb.bell_matvec(jdata, jcols, jnp.asarray(xx), interpret=True)
            for xx in x]
    got = tsb.bell_matvec_plain(_t(data), _t(cols), _t(x))
    assert got.dtype == torch.float32
    _close([got], [np.stack(want)], rtol=1e-5, what="bell_matvec")
    assert torch.equal(ops.bell_matvec(_t(data), _t(cols), _t(x)), got)


def test_k2_per_lane_tables():
    """A lane-stacked table (one block table per lane) matches each
    lane's own kernel call."""
    rng = np.random.default_rng(9)
    tables = []
    for s in range(3):
        m = rng.standard_normal((40, 40)) * (rng.random((40, 40)) < 0.15)
        tables.append(tsb.dense_to_bell((m + m.T) / 2, bs=8, k_max=5))
    data = np.stack([t[0] for t in tables])
    cols = np.stack([t[1] for t in tables])
    x = rng.standard_normal((3, 40)).astype(np.float32)
    want = [jsb.bell_matvec(jnp.asarray(d), jnp.asarray(c), jnp.asarray(xx),
                            interpret=True)
            for d, c, xx in zip(data, cols, x)]
    got = tsb.bell_matvec_plain(_t(data), _t(cols), _t(x))
    _close([got], [np.stack(want)], rtol=1e-5, what="bell per-lane")


@pytest.mark.parametrize("n,bs,lanes,b", [(64, 8, 1, 4), (100, 8, 3, 2),
                                          (37, 16, 2, 3)])
def test_k5_bell_matvec_mrhs_plain_matches_pallas(n, bs, lanes, b):
    """K5's plain version on row-stacked (L, b, N) blocks against the
    reference's SpMM kernel (interpret mode) on each lane's
    column-stacked (N, b) block; x enters in f64 and is rounded to f32
    once on both sides."""
    rng = np.random.default_rng(n + b)
    m = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
    data, cols, _ = tsb.dense_to_bell((m + m.T) / 2, bs=bs)
    npad = data.shape[0] * bs
    x = rng.standard_normal((lanes, b, npad))
    want = [jsb.bell_matvec_mrhs(jnp.asarray(data), jnp.asarray(cols),
                                 jnp.asarray(xx.T.astype(np.float32)),
                                 interpret=True).T for xx in x]
    got = tsb.bell_matvec_mrhs_plain(_t(data), _t(cols), _t(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close([got], [np.stack(want)], rtol=1e-5, what="bell_matvec_mrhs")
    assert torch.equal(ops.bell_matvec_mrhs(_t(data), _t(cols), _t(x)), got)
    # each row is K2's matvec of that row
    rows = tsb.bell_matvec_plain(_t(data), _t(cols),
                                 _t(x).reshape(-1, npad))
    _close([got.reshape(-1, npad)], [rows], rtol=1e-5, what="rows")


def test_k5_per_lane_tables():
    rng = np.random.default_rng(19)
    tables = []
    for s in range(3):
        m = rng.standard_normal((40, 40)) * (rng.random((40, 40)) < 0.15)
        tables.append(tsb.dense_to_bell((m + m.T) / 2, bs=8, k_max=5))
    data = np.stack([t[0] for t in tables])
    cols = np.stack([t[1] for t in tables])
    x = rng.standard_normal((3, 4, 40)).astype(np.float32)
    want = [jsb.bell_matvec_mrhs(jnp.asarray(d), jnp.asarray(c),
                                 jnp.asarray(xx.T), interpret=True).T
            for d, c, xx in zip(data, cols, x)]
    got = tsb.bell_matvec_mrhs_plain(_t(data), _t(cols), _t(x))
    _close([got], [np.stack(want)], rtol=1e-5, what="mrhs per-lane")


def test_k5_cuda_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tsb.bell_matvec_mrhs_cuda(torch.zeros(1, 1, 8, 8),
                                  torch.zeros(1, 1, dtype=torch.int32),
                                  torch.zeros(1, 2, 8))


def _state_inputs(op, us, steps, reorth, a=None):
    """Fused-step operands from a real (eager) JAX run of ``steps``
    iterations on ``op`` (whose dense matrix ``a``, ``_A`` by default,
    sets the spectral interval): consistent pivots and, with ``reorth``,
    the banked basis v_0..v_{steps+1} followed by zero rows."""
    from repro.core import gql
    w = np.linalg.eigvalsh(_A if a is None else a)
    lmn, lmx = float(w[0] * 0.5), float(w[-1] * 2.0)
    st = gql.gql_init(op, jnp.asarray(us), lmn, lmx)
    basis = None
    if reorth:
        rows = [st.lz.v_prev, st.lz.v]
        basis = jnp.stack(rows + [jnp.zeros_like(st.lz.v)] * (steps + 1),
                          axis=-2)
    for i in range(steps):
        st = gql.gql_step(op, st, lmn, lmx, basis=basis)
        if reorth:
            basis = basis.at[..., i + 2, :].set(st.lz.v)
    k = us.shape[0]
    scalars = [np.asarray(x) for x in (st.lz.beta, st.g, st.c, st.delta,
                                       st.delta_lr, st.delta_rr)]
    scalars += [np.full(k, lmn), np.full(k, lmx)]
    return (np.asarray(st.lz.v), np.asarray(st.lz.v_prev), scalars,
            None if basis is None else np.asarray(basis))


_A = make_spd(37, kappa=50.0, seed=5)


def _queries(k, n, seed):
    """k seeded queries; lane 0 lies in a 2-D invariant subspace, so it
    breaks down at its second step."""
    rng = np.random.default_rng(seed)
    us = rng.standard_normal((k, n))
    _, vecs = np.linalg.eigh(_A[:n, :n]) if n == _A.shape[0] else (None, None)
    if vecs is not None:
        us[0] = vecs[:, 0] + 0.5 * vecs[:, -1]
    return us


@pytest.mark.parametrize("k,sandwich,reorth", [
    (5, "plain", False), (5, "plain", True), (3, "shifted", False),
    (4, "masked", True), (1, "plain", True), (3, "per_lane", False),
    (8, "per_lane", True)])
def test_k3_fused_step_dense_plain_matches_pallas(k, sandwich, reorth):
    from repro.core import Dense, Masked, Shifted, stack_ops
    n = _A.shape[0]
    rng = np.random.default_rng(k)
    one, zero = np.ones(()), np.zeros(())
    s_out, s_in, t, a, shared = one, one, zero, _A, True
    op = Dense(jnp.asarray(_A))
    if sandwich == "shifted":
        op, t = Shifted(op, jnp.asarray(0.3)), np.asarray(0.3)
    elif sandwich == "masked":
        m = (rng.random((k, n)) < 0.7).astype(np.float64)
        op = Masked(op, jnp.asarray(m))
        s_out, s_in, t = m, m, 1.0 - m
    elif sandwich == "per_lane":
        a = np.stack([_A + 0.1 * i * np.eye(n) for i in range(k)])
        op, shared = stack_ops([Dense(jnp.asarray(x)) for x in a]), False
    us = _queries(k, n, seed=k)
    if sandwich == "masked":
        us = us * s_out
    v, vp, sc, basis = _state_inputs(op, us, 2, reorth)
    vec = [np.broadcast_to(x, (k, n)) for x in (s_out, s_in, t)]
    j = jls.fused_step_dense(
        jnp.asarray(a), *[jnp.asarray(x) for x in vec], jnp.asarray(v),
        jnp.asarray(vp), tuple(jnp.asarray(s) for s in sc),
        None if basis is None else jnp.asarray(basis), shared_a=shared,
        interpret=True)
    args = (_t(a), *[_t(x) for x in vec], _t(v), _t(vp),
            tuple(_t(s) for s in sc), None if basis is None else _t(basis))
    got = tls.fused_step_dense_plain(*args, shared_a=shared)
    _close([got[0], got[1], got[2], *got[3]], [j[0], j[1], j[2], *j[3]],
           what="fused_step_dense", floor=1.0)
    via_ops = ops.fused_step_dense(*args, shared_a=shared)
    assert torch.equal(via_ops[2], got[2])


@pytest.mark.parametrize("lanes,masked", [(3, False), (2, True)])
def test_k4_fused_step_bell_plain_matches_pallas(lanes, masked):
    from repro.core import Masked, bell_from_dense
    n = _A.shape[0]
    rng = np.random.default_rng(lanes)
    data, cols, _ = tsb.dense_to_bell(_A, bs=8, dtype=np.float32)
    npad = data.shape[0] * 8
    op = bell_from_dense(_A, bs=8, dtype=np.float32)
    s = np.ones((lanes, n))
    t = np.zeros((lanes, n))
    if masked:
        s = (rng.random((lanes, n)) < 0.7).astype(np.float64)
        t = 1.0 - s
        op = Masked(op, jnp.asarray(s))
    us = _queries(lanes, n, seed=lanes + 10) * (s if masked else 1.0)
    v, vp, scalars, _ = _state_inputs(op, us, 2, False)

    def pad(x):
        return np.pad(x, ((0, 0), (0, npad - n)))

    vecs = [pad(x) for x in (s, s, t, v, vp)]
    step = jax.vmap(lambda so, si, tt, vv, vvp, s8: jls.fused_step_bell(
        jnp.asarray(data), jnp.asarray(cols), so, si, tt, vv, vvp, s8,
        interpret=True))
    j = step(*[jnp.asarray(x) for x in vecs],
             tuple(jnp.asarray(x)[:, None] for x in scalars))
    got = tls.fused_step_bell_plain(_t(data), _t(cols),
                                    *[_t(x) for x in vecs],
                                    tuple(_t(x) for x in scalars))
    want = [np.asarray(j[0]).reshape(-1), np.asarray(j[1]).reshape(-1),
            j[2], *[np.asarray(x).reshape(-1) for x in j[3]]]
    _close([got[0], got[1], got[2], *got[3]], want, what="fused_step_bell", floor=1.0)


def test_k2_k4_plain_match_pallas_at_the_path_block_shape():
    """The main path's table shape, bs = 128 and Kb = 3, on a ring-lattice
    Laplacian (N = 1024, 4 lanes): K2's plain version against the Pallas
    kernel in interpret mode (1e-5, f32 accumulation), and K4's against
    the Pallas fused step with f32 blocks and f64 vectors (1e-12)."""
    from repro.core import bell_from_dense
    from repro_torch.data import graph_laplacian
    lap = graph_laplacian(1024, mean_degree=12, rewire=0.0, seed=0)
    data, cols, n = tsb.dense_to_bell(lap, bs=128, dtype=np.float32)
    assert data.shape == (8, 3, 128, 128) and n == 1024
    rng = np.random.default_rng(15)
    x = rng.standard_normal((4, n)).astype(np.float32)
    want = [jsb.bell_matvec(jnp.asarray(data), jnp.asarray(cols),
                            jnp.asarray(xx), interpret=True) for xx in x]
    got = tsb.bell_matvec_plain(_t(data), _t(cols), _t(x))
    _close([got], [np.stack(want)], rtol=1e-5, what="bell_matvec bs=128")

    op = bell_from_dense(lap, bs=128, dtype=np.float32)
    v, vp, scalars, _ = _state_inputs(op, rng.standard_normal((4, n)), 2,
                                      False, a=lap)
    one, zero = np.ones((4, n)), np.zeros((4, n))
    step = jax.vmap(lambda so, si, tt, vv, vvp, s8: jls.fused_step_bell(
        jnp.asarray(data), jnp.asarray(cols), so, si, tt, vv, vvp, s8,
        interpret=True))
    j = step(*[jnp.asarray(y) for y in (one, one, zero, v, vp)],
             tuple(jnp.asarray(y)[:, None] for y in scalars))
    got = tls.fused_step_bell_plain(_t(data), _t(cols), _t(one), _t(one),
                                    _t(zero), _t(v), _t(vp),
                                    tuple(_t(y) for y in scalars))
    want = [np.asarray(j[0]).reshape(-1), np.asarray(j[1]).reshape(-1),
            j[2], *[np.asarray(y).reshape(-1) for y in j[3]]]
    _close([got[0], got[1], got[2], *got[3]], want,
           what="fused_step_bell bs=128", floor=1.0)


def test_bell_route_and_split_choice():
    """The card's route for a blocked-ELL matvec (K2, K4) by the table's
    shape, K4's split count of its f64 tile, and when the tile may stage
    with 16-byte copies: pure functions of shapes and addresses."""
    shared = (torch.zeros(64, 3, 128, 128), torch.zeros(64, 3,
                                                        dtype=torch.int32))
    per_lane = (torch.zeros(2, 4, 3, 8, 8), torch.zeros(2, 4, 3,
                                                        dtype=torch.int32))
    assert tsb.route(*shared) == "tiled"
    assert tsb.route(*per_lane) == "lane"
    assert tsb.route(shared[0], per_lane[1]) == "lane"   # cols per lane
    # the main path: 64 lanes x 64 block rows of 128 fill 64 of 132 SMs
    # with the 128-row tile, so its 12 chunks split in two
    assert tls.bell_splits(64, 64, 128, 3, 132) == 2
    assert tls.bell_splits(65, 8, 128, 3, 132) == 3     # capped by chunks
    assert tls.bell_splits(3, 13, 8, 1, 132) == 1       # one chunk
    assert tls.bell_splits(4096, 64, 128, 3, 132) == 1  # the card is full
    assert 1 <= tls.bell_splits(1, 1, 4096, 64, 132) <= 8
    x = torch.zeros(4, 1025)
    assert tsb.vec16(128, shared[0], x)
    assert not tsb.vec16(6, x)                     # 24-byte rows
    assert not tsb.vec16(128, x[:, 1:])            # off the 16-byte grid
    assert tsb.vec16(2, torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("rows,ctas", [(16 * 4177, 132), (3 * 1001, 132),
                                       (112, 132), (21, 132), (5, 1)])
def test_k6_shares_partition_the_rows(rows, ctas):
    """K6's persistent shares: contiguous, nonempty, within one row of each
    other, covering every row once; the owner of a row, as the kernel
    finds it for the last-CTA count of a system, is the CTA whose share
    holds it."""
    parts = tbm.shares(rows, ctas)
    assert len(parts) == min(rows, ctas)
    assert parts[0][0] == 0 and parts[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    sizes = [hi - lo for lo, hi in parts]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    g = len(parts)
    for c, (lo, hi) in enumerate(parts):
        for r in {lo, hi - 1, (lo + hi) // 2}:
            assert ((r + 1) * g - 1) // rows == c


def test_k5_route_and_grid():
    """K5's route on the card and its launch grid: pure functions of the
    table's shape and type."""
    def table(bs, lanes=None, dtype=torch.float32):
        lead = () if lanes is None else (lanes,)
        return (torch.zeros(lead + (4, 3, bs, bs), dtype=dtype),
                torch.zeros(lead + (4, 3), dtype=torch.int32))
    assert tsb.mrhs_route(*table(128)) == "wgmma"
    assert tsb.mrhs_route(*table(256)) == "wgmma"
    assert tsb.mrhs_route(*table(8)) == "fma"
    assert tsb.mrhs_route(*table(32)) == "fma"
    assert tsb.mrhs_route(*table(128, lanes=2)) == "fma"
    assert tsb.mrhs_route(*table(128, dtype=torch.float64)) == "fma"
    # the trace path: 64 block rows of 128, 512 right-hand sides
    assert tsb.mrhs_grid("wgmma", 1, 512, 64, 128) == (4, 64, 1)
    assert tsb.mrhs_grid("wgmma", 1, 40, 8, 256) == (1, 16, 1)
    assert tsb.mrhs_grid("fma", 5, 8, 13, 32) == (13, 1, 5)
    assert tsb.mrhs_grid("fma", 1, 512, 64, 128) == (64, 8, 1)


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 (10-bit mantissa), to nearest, ties away from
    zero: cvt.rna.tf32.f32 by bit operations on the sign-magnitude word."""
    bits = v.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_k5_3xtf32_split_keeps_the_f32_contract():
    """K5's wgmma route, emulated: each f32 operand split into tf32 hi and
    lo parts, Y = Xhi Dhi + Xhi Dlo + Xlo Dhi with f32 sums, on the trace
    cell's table (the ring-lattice Laplacian, bs = 128, Kb = 3, here at
    N = 2048) and its right-hand sides (Rademacher probes over sqrt(N), and
    Gaussian ones of the same scale): within 1e-5 normwise of the f64
    product of the f32-rounded operands, where tf32 alone (hi only) is
    not."""
    from repro_torch.data import graph_laplacian
    n = 2048
    d_np, c_np, _ = tsb.dense_to_bell(
        graph_laplacian(n, mean_degree=12, rewire=0.0, seed=0), bs=128)
    data, cols = _t(d_np), _t(c_np)
    assert tuple(data.shape) == (16, 3, 128, 128)
    rng = np.random.default_rng(4)
    probes = rng.choice([-1.0, 1.0], (64, n)) / n ** 0.5
    gauss = rng.standard_normal((64, n)) / n ** 0.5
    for x64 in (probes, gauss):
        x = _t(x64).to(torch.float32)
        want = tsb.bell_matvec_ref(data.double(), cols, x.double())
        dh = _tf32_rna(data)
        dl = _tf32_rna(data - dh)
        xh = _tf32_rna(x)
        xl = _tf32_rna(x - xh)
        assert torch.equal(_tf32_rna(dh), dh) and torch.equal(_tf32_rna(xl),
                                                              xl)
        parts = [tsb.bell_matvec_ref(d, cols, v)
                 for d, v in ((dh, xl), (dl, xh), (dh, xh))]
        three = parts[0] + parts[1] + parts[2]
        scale = want.abs().max()
        err3 = float((three.double() - want).abs().max() / scale)
        err1 = float((parts[2].double() - want).abs().max() / scale)
        assert err3 <= 1e-5, err3
        assert err1 > 1e-5, err1


def test_ops_rejects_unknown_devices():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.gql_update(*([x] * 10))


def test_cuda_launchers_refuse_cpu_tensors():
    """The CUDA launchers take CUDA tensors only; a CPU tensor reaches
    the plain version through ``ops`` and nowhere else."""
    ins = [_t(x) for x in _recurrence_inputs(4, seed=1)]
    with pytest.raises(ValueError, match="CUDA"):
        tgu.gql_update_cuda(*ins)
    with pytest.raises(ValueError, match="CUDA"):
        tsb.bell_matvec_cuda(torch.zeros(1, 1, 8, 8),
                             torch.zeros(1, 1, dtype=torch.int32),
                             torch.zeros(8))
    v = torch.zeros(2, 8, dtype=torch.float64)
    one = torch.ones((), dtype=torch.float64)
    sc = (torch.zeros(2, dtype=torch.float64),) * 8
    with pytest.raises(ValueError, match="CUDA"):
        tls.fused_step_dense_cuda(torch.zeros(8, 8, dtype=torch.float64),
                                  one, one, one, v, v, sc, shared_a=True)
    with pytest.raises(ValueError, match="CUDA"):
        tls.fused_step_bell_cuda(torch.zeros(1, 1, 8, 8),
                                 torch.zeros(1, 1, dtype=torch.int32),
                                 one, one, one, v, v, sc)


def test_ref_binds_every_oracle_name_to_a_plain_version():
    """kernels.ref names one oracle per kernel: the reference module's
    names and the port's three more, each bound to the plain version."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import bilinear_matvec as tbm
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref as tref

    reference = {n for n in dir(jref) if not n.startswith("_")
                 and callable(getattr(jref, n))
                 and getattr(getattr(jref, n), "__module__", "")
                 == jref.__name__}
    assert reference == {"fused_matvec", "bell_matvec", "gql_update",
                         "flash_attention"}
    assert set(tref.__all__) == reference | {
        "bell_matvec_mrhs", "fused_step_dense", "fused_step_bell"}
    assert tref.fused_matvec is tbm.fused_matvec_plain
    assert tref.flash_attention is tfa.flash_attention_plain
    assert tref.gql_update is tgu.gql_update_plain
    assert tref.bell_matvec is tsb.bell_matvec_plain
    assert tref.bell_matvec_mrhs is tsb.bell_matvec_mrhs_plain
    assert tref.fused_step_dense is tls.fused_step_dense_plain
    assert tref.fused_step_bell is tls.fused_step_bell_plain
