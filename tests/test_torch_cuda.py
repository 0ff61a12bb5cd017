"""K1-K7 on the card: each hand-written CUDA kernel against its plain
PyTorch version on the same tensors, at small ragged shapes (lane counts
that are not a multiple of the lane block, N that is not a multiple of
the row tile or the staged column chunk), with breakdown and guard lanes.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: 1e-12 relative for the f64 kernels (FMA contraction and
summation order), 1e-5 for the f32 paths (the K2, K5 and K6 contract is
f32 accumulation; K3 with an f32 A sums in f32), 3e-2 for K6 with bf16 A. K7 is held row by row, each
(head, query row) at its own norm (``_row_close``): 1e-2 for bf16 inputs
(the output is rounded to bf16, 2^-9 relative), 2e-4 for f32 inputs.
Empty inputs on the card raise: a call launches its kernel or raises.
The LM's training and serving paths (no kernel; the dense, MoE, SSM,
hybrid, enc-dec and VLM families) are held to the port's CPU path: 1e-5
for f32, 1e-2 for int8 caches (dequantised to bf16), 2e-2 for bf16
weights.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import BIFSolver, Dense, bell_from_dense  # noqa: E402
from repro_torch.kernels import bilinear_matvec as tbm  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import gql_update as tgu  # noqa: E402
from repro_torch.kernels import lanczos_step as tls  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spmv_bell as tsb  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _spd(n, seed, density=1.0, kappa=50.0):
    """Seeded SPD matrix: sparse symmetric + diagonal shift, or a dense
    one with geometric eigenvalues."""
    rng = np.random.default_rng(seed)
    if density < 1.0:
        m = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
        a = (m + m.T) / 2
        w = np.linalg.eigvalsh(a)
        return a + np.eye(n) * ((w[-1] - w[0]) / (kappa - 1) - w[0])
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.geomspace(1.0 / kappa, 1.0, n)) @ q.T


def _close(got, want, rtol, what, floor=0.0):
    """Each output within ``rtol`` of its own largest entry, or of
    ``floor`` (1 for the unit-normalized vectors of a fused step)."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.double().cpu().numpy(), w.double().cpu().numpy()
        scale = max(np.nanmax(np.abs(np.where(np.isfinite(w), w, 0.0))),
                    floor, 1e-300)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale,
                                   equal_nan=True, err_msg=f"{what}[{i}]")


def _row_close(got, want, tol, what):
    """K7's measure: ||g - w||_2 / ||w||_2 along the last axis (a query
    row of one head), the largest over rows, within ``tol``."""
    g, w = got.double().cpu(), want.double().cpu()
    rel = float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-300)
                 ).max())
    assert rel <= tol, f"{what}: a row is {rel:.3g} off, more than {tol}"


K7_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}


def _flat(out):
    alpha, beta, r, raw = out
    return [alpha, beta, r, *raw]


def _state(op, u, lmn, lmx, steps, reorth):
    """A mid-run state of the port's reference backend: the fused step's
    vectors, its 8 scalar operands and the reorth basis (or None)."""
    s = BIFSolver.create(max_iters=32, rtol=1e-12, reorth=reorth)
    qs = s.step_n(s.init_state(op, u, lam_min=lmn, lam_max=lmx), steps)
    g = qs.st
    lanes = g.g.shape
    scalars = (g.lz.beta, g.g, g.c, g.delta, g.delta_lr, g.delta_rr,
               torch.full(lanes, lmn, dtype=g.g.dtype, device=g.g.device),
               torch.full(lanes, lmx, dtype=g.g.dtype, device=g.g.device))
    return g.lz.v.contiguous(), g.lz.v_prev.contiguous(), scalars, qs.basis


def test_k1_matches_plain(cuda):
    rng = np.random.default_rng(4)
    b = 133                                   # a ragged tail of lanes
    ins = [rng.uniform(0.5, 3.0, b), rng.uniform(0.0, 1.0, b),
           rng.uniform(0.0, 1.0, b), rng.uniform(0.1, 2.0, b),
           rng.uniform(-1.0, 1.0, b), rng.uniform(0.2, 2.0, b)]
    ins += [ins[5] - 0.05 + rng.uniform(0.0, 0.5, b),
            ins[5] - 4.0 - rng.uniform(0.0, 0.5, b),
            np.full(b, 0.05), np.full(b, 4.0)]
    ins[1][0] = 0.0                           # breakdown lane
    ins[2][1] = 0.0
    ins[5][2] = 0.0                           # zero pivot
    ins[6][3], ins[7][3] = -0.1, 0.2          # wrong-sign pivots
    xs = [torch.as_tensor(x, device=cuda) for x in ins]
    before = ops.LAUNCHES["gql_update"]
    got = ops.gql_update(*xs)
    assert ops.LAUNCHES["gql_update"] == before + 1
    assert all(g.device.type == "cuda" and g.dtype == torch.float64
               for g in got)
    _close(got, tgu.gql_update_plain(*xs), 1e-12, "K1 f64")


def test_k1_f32_matches_plain_on_a_solver_state(cuda):
    """The float instance of K1 on the recurrence inputs of a real solve
    (random inputs put some estimates' denominators at f32 rounding
    noise, which no f32 tolerance covers)."""
    n, lanes = 60, 37
    a = torch.as_tensor(_spd(n, seed=9), device=cuda)
    w = np.linalg.eigvalsh(a.cpu().numpy())
    u = torch.as_tensor(np.random.default_rng(9).standard_normal((lanes, n)),
                        device=cuda)
    s = BIFSolver.create(max_iters=32, rtol=1e-12)
    g = s.step_n(s.init_state(Dense(a), u, lam_min=0.5 * w[0],
                              lam_max=2.0 * w[-1]), 3).st
    ins = [g.lz.alpha, g.lz.beta, g.lz.beta_prev, g.g, g.c, g.delta,
           g.delta_lr, g.delta_rr, torch.full_like(g.g, 0.5 * w[0]),
           torch.full_like(g.g, 2.0 * w[-1])]
    xs = [x.to(torch.float32) for x in ins]
    got = ops.gql_update(*xs)
    assert all(x.dtype == torch.float32 for x in got)
    _close(got, tgu.gql_update_plain(*xs), 1e-5, "K1 f32")


def _k1_solver_operands(cuda, lanes, dtype, monkeypatch):
    """The operands the 'pallas' solver passes K1 at the third step of a
    real solve over ``lanes`` lanes (recorded at ``ops.gql_update``): the
    lanes (B,) and the interval as 0-d tensors; cast to ``dtype``."""
    n = 60
    a = torch.as_tensor(_spd(n, seed=9), device=cuda)
    w = np.linalg.eigvalsh(a.cpu().numpy())
    u = torch.as_tensor(np.random.default_rng(lanes).standard_normal(
        (lanes, n)), device=cuda)
    seen = []
    launch = ops.gql_update
    monkeypatch.setattr(ops, "gql_update",
                        lambda *args: seen.append(args) or launch(*args))
    s = BIFSolver.create(max_iters=32, rtol=1e-12, backend="pallas")
    s.step_n(s.init_state(Dense(a), u, lam_min=0.5 * w[0],
                          lam_max=2.0 * w[-1]), 3)
    monkeypatch.undo()
    ins = seen[-1]
    assert ins[8].ndim == 0 and ins[9].ndim == 0
    assert all(x.shape == (lanes,) for x in ins[:8])
    return [x.to(dtype) for x in ins]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("lanes", [1, 2, 64, 4177])
def test_k1_solver_operands_match_plain(cuda, lanes, dtype, tol,
                                        monkeypatch):
    """K1 at the lane counts of the applications (one or two lanes a
    judge, 64, greedy MAP's 4177) on the solver's own operands: against
    the plain version, and the 0-d interval (read at stride 0) bit-equal
    to its materialised copy."""
    ins = _k1_solver_operands(cuda, lanes, dtype, monkeypatch)
    before = ops.LAUNCHES["gql_update"]
    got = ops.gql_update(*ins)
    assert ops.LAUNCHES["gql_update"] == before + 1
    assert all(g.dtype == dtype and g.shape == (lanes,) for g in got)
    _close(got, tgu.gql_update_plain(*ins), tol, f"K1 {dtype} B={lanes}")
    full = ins[:8] + [x.expand(lanes).contiguous() for x in ins[8:]]
    for x, y in zip(got, ops.gql_update(*full)):
        assert torch.equal(x, y)


def test_k1_launches_on_the_lanes_device(cuda, monkeypatch):
    """Lanes on a device other than the current one are launched on their
    own device, as K2-K7's wrappers do, and the current device is left as
    it was: the same bits as the call made with that device current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    ins = [x.to(other) for x in
           _k1_solver_operands(cuda, 64, torch.float64, monkeypatch)]
    current = torch.cuda.current_device()
    assert current != 1
    got = ops.gql_update(*ins)
    assert torch.cuda.current_device() == current
    assert all(x.device == other for x in got)
    with torch.cuda.device(other):
        want = ops.gql_update(*ins)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    _close(got, tgu.gql_update_plain(*ins), 1e-12, "K1 on cuda:1")


def _bell_table(n, bs, seed):
    """A seeded SPD matrix for a blocked-ELL table: the ring lattice of the
    main path (Kb = 3 at bs = 128 and 40; a ridge of 0.5 keeps the step's
    recurrence well conditioned) for bs >= 32, a random sparse SPD matrix
    for smaller blocks."""
    from repro_torch.data import graph_laplacian
    if bs >= 32:
        return graph_laplacian(n, mean_degree=12, rewire=0.0, ridge=0.5,
                               seed=seed)
    return _spd(n, seed=seed, density=0.1)


# (n, bs, lanes, per_lane): bs = 128 and Kb = 3 is the main path's table;
# lane counts 1, 3, 65 and 130 leave ragged 64-lane tiles; bs = 40 is no
# multiple of the 32-row tile or the 32-column chunk; bs = 6 gives rows of
# 24 bytes, staged one element a copy instead of 16 bytes
BELL_CASES = [(100, 8, 3, False), (100, 8, 3, True), (1024, 128, 1, False),
              (1024, 128, 3, False), (1024, 128, 65, False),
              (1024, 128, 130, False), (512, 128, 3, True),
              (1000, 40, 65, False), (90, 6, 5, False)]


@pytest.mark.parametrize("n,bs,lanes,per_lane", BELL_CASES)
@pytest.mark.parametrize("data_dtype", [torch.float32, torch.float64])
def test_k2_matches_plain(cuda, n, bs, lanes, per_lane, data_dtype):
    """K2 on both routes (``spmv_bell.ROUTES`` says which ran) against its
    plain version; two launches give the same bits, and so does x staged
    from an address off the 16-byte grid (one element a copy)."""
    rng = np.random.default_rng(2)
    d_np, c_np, _ = tsb.dense_to_bell(_bell_table(n, bs, 2), bs=bs,
                                      dtype=np.float64)
    data = torch.as_tensor(d_np, dtype=data_dtype, device=cuda)
    cols = torch.as_tensor(c_np, device=cuda)
    if per_lane:
        data = torch.stack([data * (1.0 + 0.1 * i) for i in range(lanes)])
        cols = torch.stack([cols] * lanes)
    x = torch.as_tensor(rng.standard_normal((lanes, data.shape[-4] * bs)),
                        device=cuda)
    which = "lane" if per_lane else "tiled"
    assert tsb.route(data, cols) == which
    before, routed = ops.LAUNCHES["bell_matvec"], tsb.ROUTES[which]
    got = ops.bell_matvec(data, cols, x)
    assert ops.LAUNCHES["bell_matvec"] == before + 1
    assert tsb.ROUTES[which] == routed + 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close([got], [tsb.bell_matvec_plain(data, cols, x)], 1e-5, "K2")
    assert torch.equal(ops.bell_matvec(data, cols, x), got)
    if not per_lane:
        x32 = x.to(torch.float32)
        off = torch.empty(x32.numel() + 1, dtype=torch.float32,
                          device=cuda)[1:].view(x32.shape).copy_(x32)
        assert not tsb.vec16(bs, off)
        assert torch.equal(ops.bell_matvec(data, cols, off), got)
        _close([ops.bell_matvec(data, cols, x[-1])],   # one lane as a vector
               [tsb.bell_matvec_plain(data, cols, x[-1])], 1e-5, "K2 1-D")


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes,b,bs", [(3, 4, 8), (70, 3, 32),
                                        (5, 8, 128)])
def test_k5_matches_plain(cuda, per_lane, x_dtype, lanes, b, bs):
    """K5 on row-stacked (L, b, N) blocks against its plain version:
    shared and per-lane tables, ragged right-hand-side counts (L * b not
    a multiple of the 64-row tile), bs below and at the 128-entry tile,
    f32 and f64 X (rounded to f32 once)."""
    rng = np.random.default_rng(5)
    n = 300
    d_np, c_np, _ = tsb.dense_to_bell(_spd(n, seed=5, density=0.05), bs=bs)
    data = torch.as_tensor(d_np, device=cuda)
    cols = torch.as_tensor(c_np, device=cuda)
    if per_lane:
        data = torch.stack([data * (1.0 + 0.1 * i) for i in range(lanes)])
        cols = torch.stack([cols] * lanes)
    x = torch.as_tensor(rng.standard_normal((lanes, b, data.shape[-4] * bs)),
                        dtype=x_dtype, device=cuda)
    which = tsb.mrhs_route(data, cols)
    assert which == ("wgmma" if bs == 128 and not per_lane else "fma")
    before, routed = ops.LAUNCHES["bell_matvec_mrhs"], tsb.MRHS_ROUTES[which]
    got = ops.bell_matvec_mrhs(data, cols, x)
    assert ops.LAUNCHES["bell_matvec_mrhs"] == before + 1
    assert tsb.MRHS_ROUTES[which] == routed + 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close([got], [tsb.bell_matvec_mrhs_plain(data, cols, x)], 1e-5, "K5")
    again = ops.bell_matvec_mrhs(data, cols, x)
    assert torch.equal(got, again)      # no atomics: the same bits


# (lanes, b, n, bs): the trace path's 512 right-hand sides (64 lanes of 8)
# on the ring lattice's table (Kb = 3); 40 and 300 rows, which are no
# multiple of the 128-row tile; one row; bs = 256, two output tiles a
# block row
K5_WGMMA_CASES = [(64, 8, 2048, 128), (5, 8, 1024, 128), (3, 100, 1024, 128),
                  (1, 1, 512, 128), (4, 8, 1024, 256)]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes,b,n,bs", K5_WGMMA_CASES)
def test_k5_wgmma_route_matches_plain(cuda, x_dtype, lanes, b, n, bs):
    """K5's 3xTF32 route on a shared f32 table against its plain version
    (f32 FMA sums): within the f32 contract's 1e-5, every launch on the
    wgmma route, the same bits on two launches."""
    rng = np.random.default_rng(n + b)
    d_np, c_np, _ = tsb.dense_to_bell(_bell_table(n, bs, 11), bs=bs)
    data = torch.as_tensor(d_np, device=cuda)
    cols = torch.as_tensor(c_np, device=cuda)
    x = torch.as_tensor(rng.standard_normal((lanes, b, n)) / n ** 0.5,
                        dtype=x_dtype, device=cuda)
    assert tsb.mrhs_route(data, cols) == "wgmma"
    routed = tsb.MRHS_ROUTES["wgmma"]
    got = ops.bell_matvec_mrhs(data, cols, x)
    assert tsb.MRHS_ROUTES["wgmma"] == routed + 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close([got], [tsb.bell_matvec_mrhs_plain(data, cols, x)], 1e-5,
           "K5 wgmma")
    assert torch.equal(ops.bell_matvec_mrhs(data, cols, x), got)


@pytest.mark.parametrize("bs,per_lane", [(128, False), (32, False),
                                         (128, True)])
def test_k5_nan_in_x_lands_where_the_plain_version_puts_it(cuda, bs,
                                                          per_lane):
    """A NaN planted in X gives non-finite entries exactly where the plain
    version's are, on both routes (the padding blocks point at column 0
    and carry a NaN there to every row that has one)."""
    n, lanes, b = 1024, 4, 8
    d_np, c_np, _ = tsb.dense_to_bell(_bell_table(n, bs, 12), bs=bs)
    data = torch.as_tensor(d_np, device=cuda)
    cols = torch.as_tensor(c_np, device=cuda)
    if per_lane:
        data = torch.stack([data] * lanes)
        cols = torch.stack([cols] * lanes)
    rng = np.random.default_rng(13)
    for col in (5, 700):
        x = torch.as_tensor(rng.standard_normal((lanes, b, n)), device=cuda)
        x[2, 3, col] = float("nan")
        got = ops.bell_matvec_mrhs(data, cols, x)
        want = tsb.bell_matvec_mrhs_plain(data, cols, x)
        bad = ~torch.isfinite(want)
        assert bool(bad.any())
        assert torch.equal(~torch.isfinite(got), bad)
        _close([torch.where(bad, 0.0, got)], [torch.where(bad, 0.0, want)],
               1e-5, "K5 finite entries")


def test_k5_refuses_empty_inputs(cuda):
    """No lane, or no row of a lane: the card raises rather than count a
    launch that did not happen."""
    data, cols, _ = tsb.dense_to_bell(_spd(64, seed=3), bs=32)
    data = torch.as_tensor(data, device=cuda)
    cols = torch.as_tensor(cols, device=cuda)
    before = ops.LAUNCHES["bell_matvec_mrhs"]
    for shape in ((0, 2, 64), (3, 0, 64)):
        with pytest.raises(ValueError, match="nonempty"):
            ops.bell_matvec_mrhs(data, cols, torch.zeros(shape, device=cuda))
    assert ops.LAUNCHES["bell_matvec_mrhs"] == before


def test_k5_through_matvec_mrhs_with_ragged_n(cuda):
    """N = 300 is not a multiple of bs: the operator pads x to R * bs and
    slices the result back; each row equals K2's matvec of that row."""
    from repro_torch.core import SparseBELL, stack_ops
    from repro_torch.core.operators import matvec_mrhs
    rng = np.random.default_rng(6)
    a = _spd(300, seed=6, density=0.05)
    op = bell_from_dense(a, bs=32, dtype=np.float32, device=cuda,
                         mode="pallas")
    assert isinstance(op, SparseBELL)
    x = torch.as_tensor(rng.standard_normal((4, 3, 300)), device=cuda)
    got = matvec_mrhs(op, x)
    assert got.dtype == torch.float64 and got.shape == x.shape
    rows = torch.stack([op.matvec(x[:, j]) for j in range(3)], dim=1)
    _close([got], [rows], 1e-5, "K5 vs K2 rows")
    ref = matvec_mrhs(bell_from_dense(a, bs=32, dtype=np.float32,
                                      device="cpu", mode="pallas"), x.cpu())
    _close([got], [ref], 1e-5, "K5 vs plain")
    st = stack_ops([op, op])
    got2 = matvec_mrhs(st, x[:2])
    _close([got2], [got[:2]], 1e-5, "K5 per-lane tables")


def test_k5_drives_the_block_solver(cuda):
    """A block solve on 'pallas' launches K5 once at init and once per
    block step, and matches the plain path's discrete outcomes."""
    rng = np.random.default_rng(7)
    a = _spd(256, seed=7, density=0.05)
    w = np.linalg.eigvalsh(a.astype(np.float32).astype(np.float64))
    us = rng.standard_normal((6, 4, 256))
    iv = dict(lam_min=0.9 * w[0], lam_max=1.1 * w[-1])
    s = BIFSolver.create(max_iters=40, rtol=1e-6, block_size=4, fn="log",
                         backend="pallas")
    op = bell_from_dense(a, bs=32, dtype=np.float32, device=cuda)
    before = ops.LAUNCHES["bell_matvec_mrhs"]
    res = s.solve_batch(op, torch.as_tensor(us, device=cuda), **iv)
    launches = ops.LAUNCHES["bell_matvec_mrhs"] - before
    assert launches == int(res.iterations.max())
    cpu = s.solve_batch(bell_from_dense(a, bs=32, dtype=np.float32,
                                        device="cpu"),
                        torch.as_tensor(us), **iv)
    assert torch.equal(res.certified.cpu(), cpu.certified)
    assert int((res.iterations.cpu() - cpu.iterations).abs().max()) <= 1
    _close([res.lower, res.upper], [cpu.lower, cpu.upper], 1e-5,
           "block bracket")


@pytest.mark.parametrize("n,lanes,reorth,kind", [
    (37, 5, False, "plain"), (37, 5, True, "plain"),
    (600, 11, True, "plain"), (600, 70, False, "plain"),
    (4177, 64, True, "plain"),             # the main path's N and lanes
    (33, 5, True, "plain"), (1000, 63, True, "plain"),   # ragged N
    (1000, 1, True, "plain"), (1000, 65, False, "plain"),
    (600, 130, True, "plain"),             # lanes across tile edges
    (45, 3, False, "per_lane"),
    (45, 9, True, "masked"), (1000, 65, False, "masked"),
    (600, 11, True, "f32"), (37, 70, False, "f32")])
def test_k3_matches_plain(cuda, n, lanes, reorth, kind):
    a_np = _spd(n, seed=n)
    rng = np.random.default_rng(n + lanes)
    u = rng.standard_normal((lanes, n))
    a = torch.as_tensor(a_np, device=cuda)
    one = torch.ones((), dtype=a.dtype, device=cuda)
    s_out, s_in, t, shared = one, one, one * 0.0, True
    op = Dense(a)
    if kind == "per_lane":
        a = torch.stack([a + 0.1 * i * torch.eye(n, dtype=a.dtype,
                                                 device=cuda)
                         for i in range(lanes)])
        op, shared = Dense(a), False
    elif kind == "masked":
        m = torch.as_tensor((rng.random((lanes, n)) < 0.7).astype(float),
                            device=cuda)
        from repro_torch.core import stack_masks
        op = stack_masks(Dense(a), m)
        s_out, s_in, t = m, m, 1.0 - m
        u = u * m.cpu().numpy()
    w = np.linalg.eigvalsh(a_np)
    v, vp, sc, basis = _state(op, torch.as_tensor(u, device=cuda),
                              0.5 * w[0], 2.0 * w[-1], 2, reorth)
    if basis is not None:
        basis = basis.contiguous()
    if kind == "f32":
        a, v, vp, basis, one = (None if x is None else x.to(torch.float32)
                                for x in (a, v, vp, basis, one))
        sc = tuple(x.to(torch.float32) for x in sc)
        s_out, s_in, t = one, one, one * 0.0
    args = (a.contiguous(), s_out, s_in, t, v, vp, sc, basis)
    route = "lane" if not shared else "fma_f32" if kind == "f32" \
        else "dmma"
    before = ops.LAUNCHES["fused_step_dense"]
    routed = tls.ROUTES[route]
    got = ops.fused_step_dense(*args, shared_a=shared)
    assert ops.LAUNCHES["fused_step_dense"] == before + 1
    assert tls.ROUTES[route] == routed + 1
    want = tls.fused_step_dense_plain(*args, shared_a=shared)
    _close(_flat(got), _flat(want), 1e-5 if kind == "f32" else 1e-12,
           f"K3 {kind}", floor=1.0)


def _rows_state(op, u, lmn, lmx, steps, basis_rows):
    """A reference-backend state after ``steps`` steps with a basis of
    ``basis_rows`` rows, and the count of its live rows, min(steps + 2,
    M), as the fused stepper passes it."""
    s = BIFSolver.create(max_iters=32, rtol=1e-12, reorth=True)
    qs = s.step_n(s.init_state(op, u, lam_min=lmn, lam_max=lmx,
                               basis_rows=basis_rows), steps)
    g = qs.st
    lanes = g.g.shape
    scalars = (g.lz.beta, g.g, g.c, g.delta, g.delta_lr, g.delta_rr,
               torch.full(lanes, lmn, dtype=g.g.dtype, device=g.g.device),
               torch.full(lanes, lmx, dtype=g.g.dtype, device=g.g.device))
    rows = torch.clamp(qs.step + 2, max=basis_rows).to(torch.int32)
    return (g.lz.v.contiguous(), g.lz.v_prev.contiguous(), scalars,
            qs.basis.contiguous(), rows)


@pytest.mark.parametrize("n,lanes", [(1000, 64), (4177, 64), (333, 70)])
@pytest.mark.parametrize("steps", [0, 6, 12])
def test_k3_live_rows_match_the_full_basis(cuda, n, lanes, steps):
    """With ``rows`` (2, a mid count, and M = 14) the kernel reads only
    the live basis rows; the plain version reads all M and agrees."""
    a_np = _spd(n, seed=n + 1)
    w = np.linalg.eigvalsh(a_np)
    a = torch.as_tensor(a_np, device=cuda)
    u = torch.as_tensor(np.random.default_rng(n).standard_normal(
        (lanes, n)), device=cuda)
    v, vp, sc, basis, rows = _rows_state(Dense(a), u, 0.5 * w[0],
                                         2.0 * w[-1], steps, 14)
    assert int(rows) == min(steps + 2, 14)
    assert int(torch.count_nonzero(basis[:, int(rows):])) == 0
    one = torch.ones((), dtype=a.dtype, device=cuda)
    args = (a, one, one, one * 0.0, v, vp, sc, basis)
    live = tls.ROUTES["live_rows"]
    got = ops.fused_step_dense(*args, shared_a=True, rows=rows)
    assert tls.ROUTES["live_rows"] == live + 1
    want = tls.fused_step_dense_plain(*args, shared_a=True)
    _close(_flat(got), _flat(want), 1e-12, "K3 live rows", floor=1.0)


def test_k3_gives_the_same_bits_run_to_run(cuda):
    """The column splits and the tail's cluster partials are added in a
    fixed order: two launches on the same inputs agree bit for bit."""
    n, lanes = 4177, 64
    a_np = _spd(n, seed=3)
    w = np.linalg.eigvalsh(a_np)
    a = torch.as_tensor(a_np, device=cuda)
    u = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (lanes, n)), device=cuda)
    v, vp, sc, basis, rows = _rows_state(Dense(a), u, 0.5 * w[0],
                                         2.0 * w[-1], 5, 161)
    one = torch.ones((), dtype=a.dtype, device=cuda)
    args = (a, one, one, one * 0.0, v, vp, sc, basis)
    first = _flat(ops.fused_step_dense(*args, shared_a=True, rows=rows))
    second = _flat(ops.fused_step_dense(*args, shared_a=True, rows=rows))
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("data_dtype,vec_dtype,rtol", [
    (torch.float32, torch.float64, 1e-12),
    (torch.float64, torch.float64, 1e-12),
    (torch.float32, torch.float32, 1e-5)])
@pytest.mark.parametrize("n,bs,lanes,per_lane", BELL_CASES)
@pytest.mark.parametrize("scale", ["scalar", "shared", "per_lane"])
def test_k4_matches_plain(cuda, data_dtype, vec_dtype, rtol, n, bs, lanes,
                          per_lane, scale):
    """K4 on both routes, with s_in one scalar, a vector shared by the
    lanes or a vector a lane (the tile stages the last two as rows; s_out
    is the same vector, so the sandwich stays symmetric), on the f64
    tile's split chunk walk where the split count exceeds 1; two launches
    give the same bits."""
    a_np = _bell_table(n, bs, 6)
    bell = bell_from_dense(a_np, bs=bs, device=cuda)
    w = np.linalg.eigvalsh(a_np)
    rng = np.random.default_rng(6)
    u = rng.standard_normal((lanes, n))
    v, vp, sc, _ = _state(bell, torch.as_tensor(u, device=cuda),
                          0.5 * w[0], 2.0 * w[-1], 2, False)
    data, cols = bell.data.to(data_dtype), bell.cols
    if per_lane:
        data = torch.stack([data * (1.0 + 0.1 * i) for i in range(lanes)])
        cols = torch.stack([cols] * lanes)
    npad = data.shape[-4] * bs
    pad = (0, npad - n)
    one = torch.ones((), dtype=vec_dtype, device=cuda)
    s_in = {"scalar": one,
            "shared": torch.as_tensor(rng.uniform(0.9, 1.1, npad),
                                      dtype=vec_dtype, device=cuda),
            "per_lane": torch.as_tensor(rng.uniform(0.9, 1.1, (lanes, npad)),
                                        dtype=vec_dtype, device=cuda)}[scale]
    args = (data.contiguous(), cols.contiguous(), s_in, s_in, one * 0.25,
            torch.nn.functional.pad(v, pad).to(vec_dtype),
            torch.nn.functional.pad(vp, pad).to(vec_dtype),
            tuple(s.to(vec_dtype) for s in sc))
    which = "bell_lane" if per_lane else "bell_dmma" \
        if vec_dtype == torch.float64 else "bell_fma_f32"
    before, routed = ops.LAUNCHES["fused_step_bell"], tls.ROUTES[which]
    got = ops.fused_step_bell(*args)
    assert ops.LAUNCHES["fused_step_bell"] == before + 1
    assert tls.ROUTES[which] == routed + 1
    want = tls.fused_step_bell_plain(*args)
    _close(_flat(got), _flat(want), rtol, "K4", floor=1.0)
    for x, y in zip(_flat(got), _flat(ops.fused_step_bell(*args))):
        assert torch.equal(x, y)
    if (n, bs, lanes) == (1024, 128, 65):   # the split walk is exercised
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert tls.bell_splits(lanes, n // bs, bs, 3, sms) > 1


def _rewired_args(cuda, n, bs, lanes, data_dtype, scale, seed=7):
    """K4's operands on a rewired ring (the GMRF cell's stand-in at a
    smaller size: Watts-Strogatz rewiring spreads each block row over most
    block columns, hundreds of stored values per non-zero), from a state
    two steps in; s_in one scalar, a row shared by the lanes or a row a
    lane (s_out the same)."""
    from repro_torch.data import graph_laplacian
    a_np = graph_laplacian(n, mean_degree=6, rewire=0.05, ridge=0.5,
                           seed=seed)
    bell = bell_from_dense(a_np, bs=bs, device=cuda)
    w = np.linalg.eigvalsh(a_np)
    rng = np.random.default_rng(seed)
    v, vp, sc, _ = _state(bell, torch.as_tensor(
        rng.standard_normal((lanes, n)), device=cuda), 0.5 * w[0],
        2.0 * w[-1], 2, False)
    npad = bell.data.shape[0] * bs
    f64 = dict(dtype=torch.float64, device=cuda)
    one = torch.ones((), **f64)
    s_in = {"scalar": one,
            "shared": torch.as_tensor(rng.uniform(0.9, 1.1, npad), **f64),
            "per_lane": torch.as_tensor(rng.uniform(0.9, 1.1, (lanes, npad)),
                                        **f64)}[scale]
    pad = (0, npad - n)
    return (bell.data.to(data_dtype).contiguous(), bell.cols, s_in, s_in,
            one * 0.25, torch.nn.functional.pad(v, pad).contiguous(),
            torch.nn.functional.pad(vp, pad).contiguous(), sc)


# (n, bs): 2000 nodes leave a ragged last block row; 975 nodes in blocks of
# 75 give an odd row length, staged one element a copy
ROWS_CASES = [(2000, 128), (1024, 128), (975, 75)]


@pytest.mark.parametrize("data_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,bs", ROWS_CASES)
@pytest.mark.parametrize("lanes", [1, 3, 65])
@pytest.mark.parametrize("scale", ["scalar", "shared", "per_lane"])
def test_k4_rows_route_matches_plain(cuda, data_dtype, n, bs, lanes, scale):
    """A sparse-filled shared table with f64 vectors takes the rows route
    (one launch, counted once in LAUNCHES and in ROUTES["bell_rows"]) and
    agrees with the plain version; two launches give the same bits."""
    args = _rewired_args(cuda, n, bs, lanes, data_dtype, scale)
    assert tsb.table_rows(args[0], args[1]).fill > tsb.ROWS_FILL
    before = ops.LAUNCHES["fused_step_bell"], tls.ROUTES["bell_rows"]
    got = ops.fused_step_bell(*args)
    assert (ops.LAUNCHES["fused_step_bell"], tls.ROUTES["bell_rows"]) == \
        (before[0] + 1, before[1] + 1)
    _close(_flat(got), _flat(tls.fused_step_bell_plain(*args)), 1e-12,
           "K4 rows", floor=1.0)
    for x, y in zip(_flat(got), _flat(ops.fused_step_bell(*args))):
        assert torch.equal(x, y)


def test_k4_rows_route_keeps_a_nan_in_its_lane(cuda):
    """A NaN planted in one lane's v reaches that lane's alpha through its
    non-zero diagonal, so alpha, beta and r go non-finite in that lane
    alone, as in the plain version; the other lanes agree with it."""
    args = list(_rewired_args(cuda, 2000, 128, 5, torch.float32, "scalar"))
    args[5] = args[5].clone()
    args[5][2, 17] = float("nan")
    got = ops.fused_step_bell(*args)
    want = tls.fused_step_bell_plain(*args)
    smem = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    assert tls.bell_route(args[0], args[1], torch.float64, smem)[0] == \
        "bell_rows"
    for out in (got, want):
        alpha, beta, r, _ = out
        bad = ~torch.isfinite(alpha)
        assert bad.tolist() == [False, False, True, False, False]
        assert torch.equal(~torch.isfinite(beta), bad)
        assert torch.equal(~torch.isfinite(r).all(dim=1), bad)
        assert bool(torch.isfinite(r[~bad]).all())
    keep = [0, 1, 3, 4]
    _close([x[keep] for x in _flat(got)], [x[keep] for x in _flat(want)],
           1e-12, "K4 rows, finite lanes", floor=1.0)


def test_k1_to_k4_refuse_empty_inputs(cuda):
    """No lane: the card raises rather than count a launch that did not
    happen (K5-K7 have their own cases)."""
    f64 = dict(dtype=torch.float64, device=cuda)
    none = torch.zeros(0, **f64)
    with pytest.raises(ValueError, match="nonempty"):
        ops.gql_update(*([none] * 10))
    d_np, c_np, _ = tsb.dense_to_bell(_spd(64, seed=3), bs=32)
    data = torch.as_tensor(d_np, device=cuda)
    cols = torch.as_tensor(c_np, device=cuda)
    with pytest.raises(ValueError, match="nonempty"):
        ops.bell_matvec(data, cols, torch.zeros(0, 64, device=cuda))
    v = torch.zeros(0, 64, **f64)
    one = torch.ones((), **f64)
    sc = (none,) * 8
    with pytest.raises(ValueError, match="nonempty"):
        ops.fused_step_bell(data.double(), cols, one, one, one, v, v, sc)
    with pytest.raises(ValueError, match="nonempty"):
        ops.fused_step_dense(torch.zeros(64, 64, **f64), one, one, one, v, v,
                             sc, shared_a=True)


def test_launchers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):      # lanes must be flat (B,)
        ops.gql_update(x, x, x, x.reshape(2, 2), x, x, x, x, x, x)
    a = torch.zeros(4, 4, dtype=torch.float64, device=cuda)
    v = torch.zeros(2, 4, dtype=torch.float64, device=cuda)
    one = torch.ones((), dtype=torch.float64, device=cuda)
    sc = tuple(torch.zeros(2, dtype=torch.float64, device=cuda)
               for _ in range(8))
    with pytest.raises(ValueError):      # v_prev not contiguous
        ops.fused_step_dense(a, one, one, one, v, v.T.contiguous().T, sc,
                             shared_a=True)
    with pytest.raises(ValueError):      # per-lane A of the wrong shape
        ops.fused_step_dense(a, one, one, one, v, v, sc, shared_a=False)


@pytest.mark.parametrize("b,n,a_dtype,x_dtype", [
    (2, 4177, torch.float32, torch.float32),    # rows start 4-byte aligned
    (3, 4177, torch.float32, torch.float64),
    (1, 300, torch.float32, torch.float32),
    (2, 1001, torch.bfloat16, torch.float32),   # rows start 2-byte aligned
    (1, 4177, torch.bfloat16, torch.float64),
    (4, 7, torch.float32, torch.float32)])      # shorter than one vector
def test_k6_matches_plain(cuda, b, n, a_dtype, x_dtype):
    rng = np.random.default_rng(n + b)
    a = rng.standard_normal((b, n, n)).astype(np.float32)
    a = torch.as_tensor((a + np.swapaxes(a, 1, 2)) / 2, device=cuda
                        ).to(a_dtype)
    x = torch.as_tensor(rng.standard_normal((b, n)), dtype=x_dtype,
                        device=cuda)
    before = ops.LAUNCHES["fused_matvec"]
    y, alpha = ops.fused_matvec(a, x)
    assert ops.LAUNCHES["fused_matvec"] == before + 1
    assert y.dtype == alpha.dtype == torch.float32
    assert tuple(y.shape) == (b, n) and tuple(alpha.shape) == (b,)
    yw, alw = tbm.fused_matvec_plain(a, x)
    tol = 1e-5 if a_dtype == torch.float32 else 3e-2
    _close([y], [yw], tol, "K6 y")
    _close([alpha], [alw], tol * 5, "K6 alpha")
    y2, alpha2 = ops.fused_matvec(a, x)
    assert torch.equal(y, y2) and torch.equal(alpha, alpha2)  # no atomics


def _device_kernels(fn) -> int:
    """Device kernels (and copies) one call of ``fn`` runs, after a warm
    call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA)


@pytest.mark.parametrize("n", [7, 1001, 4177])
@pytest.mark.parametrize("systems", [3, 16])
@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.float64])
def test_k6_shares_across_systems(cuda, n, systems, a_dtype, x_dtype):
    """K6's persistent shares of the B * N rows cross system boundaries
    (at 16 x 4177 the main path's shape): y and alpha against the plain
    version, one device kernel per call, the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(n + systems)
    a = torch.randn((systems, n, n), generator=g, device=cuda).to(a_dtype)
    x = torch.randn((systems, n), generator=g, device=cuda,
                    dtype=torch.float64).to(x_dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    parts = tbm.shares(systems * n, sms)
    crossing = any(lo // n != (hi - 1) // n for lo, hi in parts)
    # 16 systems of 1001 or 4177 rows split across 132 SMs: some share
    # crosses a system boundary and restages x (3 divides 132, so the
    # shares of 3 systems end on their boundaries)
    assert crossing or n == 7 or sms % systems == 0
    y, alpha = ops.fused_matvec(a, x)
    yw, alw = tbm.fused_matvec_plain(a, x)
    tol = 1e-5 if a_dtype == torch.float32 else 3e-2
    _close([y], [yw], tol, "K6 y")
    _close([alpha], [alw], tol * 5, "K6 alpha")
    assert _device_kernels(lambda: ops.fused_matvec(a, x)) == 1
    y2, alpha2 = ops.fused_matvec(a, x)
    assert torch.equal(y, y2) and torch.equal(alpha, alpha2)


def test_k6_reads_a_strided_x_in_place(cuda):
    """x as a column slice and as a transposed view: read with its strides,
    in one kernel (no copy), equal to the contiguous call's bits and to the
    plain version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, n = 5, 1001
    a = torch.randn((b, n, n), generator=g, device=cuda)
    wide = torch.randn((b, 2 * n), generator=g, device=cuda,
                       dtype=torch.float64)
    views = [wide[:, ::2], wide[:, :n].T.contiguous().T]
    for x in views:
        assert not x.is_contiguous()
        y, alpha = ops.fused_matvec(a, x)
        yc, alc = ops.fused_matvec(a, x.contiguous())
        assert torch.equal(y, yc) and torch.equal(alpha, alc)
        yw, alw = tbm.fused_matvec_plain(a, x)
        _close([y], [yw], 1e-5, "K6 strided y")
        _close([alpha], [alw], 5e-5, "K6 strided alpha")
        assert _device_kernels(lambda: ops.fused_matvec(a, x)) == 1


def test_k1_is_one_kernel_a_call_on_the_solver_operands(cuda, monkeypatch):
    """No copy, no fill: a call on the solver's operands (0-d interval,
    strided lanes) runs K1 alone. (It sits beside K6's profiled tests: in
    a session the profiler first traced much earlier, it recorded no
    launch of the port's libraries; PERF.md section 7.)"""
    ins = _k1_solver_operands(cuda, 64, torch.float64, monkeypatch)
    assert _device_kernels(lambda: ops.gql_update(*ins)) == 1
    wide = [torch.stack([x, x], 1)[:, 0] for x in ins[:8]] + ins[8:]
    got = ops.gql_update(*wide)
    assert _device_kernels(lambda: ops.gql_update(*wide)) == 1
    for x, y in zip(got, ops.gql_update(*ins)):
        assert torch.equal(x, y)


def test_k6_refuses_what_it_does_not_take(cuda):
    a = torch.zeros(1, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="fused_matvec wants x"):
        ops.fused_matvec(a, torch.zeros(3, 8, device=cuda))
    with pytest.raises(TypeError):
        ops.fused_matvec(a.double(), torch.zeros(1, 8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_matvec(torch.zeros(1, 8, 16, device=cuda)[:, :, :8],
                         torch.zeros(1, 8, device=cuda))
    before = ops.LAUNCHES["fused_matvec"]
    with pytest.raises(ValueError, match="nonempty"):     # no system
        ops.fused_matvec(torch.zeros(0, 8, 8, device=cuda),
                         torch.zeros(0, 8, device=cuda))
    assert ops.LAUNCHES["fused_matvec"] == before


def test_k6_drives_the_batched_solver(cuda):
    """MatvecFn over fused_matvec on 'pallas' (K6 + K1): K6 launches once
    at init and once per step of the longest lane, and the discrete
    outcomes match the same solve on the CPU's plain path."""
    from repro_torch.core import MatvecFn
    rng = np.random.default_rng(8)
    n, b = 300, 5
    k = _spd(n, seed=8, kappa=100.0)
    a32 = np.stack([k + 0.01 * (i + 1) * np.eye(n)
                    for i in range(b)]).astype(np.float32)
    w = np.linalg.eigvalsh(a32.astype(np.float64))
    u = rng.standard_normal((b, n))
    iv = dict(lam_min=0.9 * w[:, 0], lam_max=1.1 * w[:, -1])
    s = BIFSolver.create(max_iters=80, rtol=1e-4, backend="pallas")

    def op(dev):
        a = torch.as_tensor(a32, device=dev)
        return MatvecFn(fn=lambda x: ops.fused_matvec(a, x)[0], n_static=n,
                        diag_vals=torch.diagonal(a, dim1=1, dim2=2))

    def ivs(dev):
        return {k_: torch.as_tensor(v, device=dev) for k_, v in iv.items()}

    before = ops.LAUNCHES["fused_matvec"]
    res = s.solve_batch(op(cuda), torch.as_tensor(u, device=cuda),
                        **ivs(cuda))
    assert ops.LAUNCHES["fused_matvec"] - before == int(res.iterations.max())
    cpu = s.solve_batch(op("cpu"), torch.as_tensor(u), **ivs("cpu"))
    assert bool(res.certified.all()) and torch.equal(res.certified.cpu(),
                                                     cpu.certified)
    assert int((res.iterations.cpu() - cpu.iterations).abs().max()) <= 1
    _close([res.lower, res.upper], [cpu.lower, cpu.upper], 1e-5,
           "K6 path bracket")


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s,causal", [
    (100, 100, True), (100, 100, False),   # a ragged query and key tile
    (1, 200, False),                       # decode: one query, S = 200
    (48, 96, True),                        # zero-aligned causal, T != S
    (130, 200, False)])                    # padded tail of the keys
def test_k7_matches_plain(cuda, d, dtype, t, s, causal):
    rng = np.random.default_rng(d + t + s)
    q, k, v = (torch.as_tensor(rng.standard_normal(sh), dtype=torch.float32,
                               device=cuda).to(dtype)
               for sh in ((3, t, d), (3, s, d), (3, s, d)))
    before = ops.LAUNCHES["flash_attention"]
    o = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert o.dtype == dtype and tuple(o.shape) == (3, t, d)
    assert bool(torch.isfinite(o.float()).all())
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    _row_close(o, want, K7_TOL[dtype], "K7")
    assert torch.equal(o, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_flash_gqa_matches_plain(cuda, dtype):
    """One launch over (B, T, H, D) views with the kv-head index gives the
    reference wrapper's repeat-and-flatten result."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(rng.standard_normal(sh), dtype=torch.float32,
                               device=cuda).to(dtype)
               for sh in ((2, 70, 8, 64), (2, 70, 2, 64), (2, 70, 2, 64)))
    before = ops.LAUNCHES["flash_attention"]
    o = ops.mha_flash(q, k, v, causal=True)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    kr, vr = (x.repeat_interleave(4, dim=2) for x in (k, v))
    want = tfa.flash_attention_plain(
        q.transpose(1, 2).reshape(16, 70, 64),
        kr.transpose(1, 2).reshape(16, 70, 64),
        vr.transpose(1, 2).reshape(16, 70, 64)).reshape(2, 8, 70, 64
                                                        ).transpose(1, 2)
    _row_close(o, want, K7_TOL[dtype], "mha_flash")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("ratio", [1, 8, 16])
@pytest.mark.parametrize("t,s,causal", [
    (1, 200, False),        # decode: below one 64-row tile
    (63, 63, True), (64, 64, True),        # at and below the 64-row tile
    (200, 200, True), (200, 200, False),   # across the 128-row CTA tile
    (128, 300, False),      # a ragged key tile
    (96, 160, True), (160, 96, True),      # causal with T != S
    (700, 700, True),       # an odd count of key tiles across CTAs
    (4096, 4096, True)])    # the prefill's length
def test_mha_flash_routes_match_plain(cuda, d, ratio, t, s, causal):
    """bf16 grouped-query attention on each route (``wgmma`` from one
    64-row query tile at D = 64 and 128, ``mma_sync`` below it) against
    the reference's repeat-and-flatten, row by row, and run to run."""
    hkv = 2
    h = hkv * ratio
    rng = np.random.default_rng(d + ratio + t + s)
    q, k, v = (torch.as_tensor(rng.standard_normal(sh), dtype=torch.float32,
                               device=cuda).to(torch.bfloat16)
               for sh in ((1, t, h, d), (1, s, hkv, d), (1, s, hkv, d)))
    route = "wgmma" if t >= 64 else "mma_sync"
    assert tfa.route(torch.bfloat16, d, t) == route
    routed = tfa.ROUTES[route]
    o = ops.mha_flash(q, k, v, causal=causal)
    assert tfa.ROUTES[route] == routed + 1
    assert bool(torch.isfinite(o.float()).all())
    kr, vr = (x.repeat_interleave(ratio, dim=2) for x in (k, v))
    for h0 in range(0, h, 16):   # the plain scores, 16 heads at a time
        hs = slice(h0, min(h0 + 16, h))
        want = tfa.flash_attention_plain(
            *(x[0, :, hs].transpose(0, 1) for x in (q, kr, vr)),
            causal=causal)
        _row_close(o[0, :, hs].transpose(0, 1), want, 1e-2,
                   f"route {route}")
    assert torch.equal(o, ops.mha_flash(q, k, v, causal=causal))


def test_k7_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head widths"):
        ops.flash_attention(q, q, q)
    q = torch.zeros(2, 8, 32, device=cuda)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="nonempty"):     # no query row
        ops.flash_attention(q[:, :0], q, q)
    with pytest.raises(ValueError, match="nonempty"):
        ops.mha_flash(torch.zeros(1, 0, 4, 32, device=cuda),
                      torch.zeros(1, 5, 2, 32, device=cuda),
                      torch.zeros(1, 5, 2, 32, device=cuda))
    assert ops.LAUNCHES["flash_attention"] == before


# -- the serving path: BIFEngine's pool on the card --------------------------

def _engine_traffic(n=200, count=100, seed=61):
    """A 64-lane engine's traffic: judges 2-4x off their truth, brackets,
    every 8th request over a principal-submatrix mask."""
    from repro_torch.serve import BIFRequest
    a = _spd(n, seed, kappa=50.0)
    rng = np.random.default_rng(seed + 1)
    us = rng.standard_normal((count, n))
    true = np.einsum("ki,ki->k", us, np.linalg.solve(a, us.T).T)
    reqs = []
    for i, u in enumerate(us):
        mask = (rng.random(n) < 0.5).astype(float) if i % 8 == 7 else None
        f = rng.uniform(2.0, 4.0)
        t = None if i % 4 == 0 or mask is not None else \
            float(true[i] * (f if i % 2 else 1.0 / f))
        reqs.append(lambda u=u, t=t, mask=mask: BIFRequest(u=u, t=t,
                                                           mask=mask))
    w = np.linalg.eigvalsh(a)
    return a, reqs, dict(lam_min=float(w[0] * 0.99),
                         lam_max=float(w[-1] * 1.01))


@pytest.mark.parametrize("backend", ["pallas", "fused"])
@pytest.mark.parametrize("mode", ["continuous", "lockstep"])
def test_bif_engine_flush_on_the_card_matches_cpu_plain(cuda, backend, mode):
    """A 64-lane flush whose pool lives on the card (K1 on 'pallas', K3 on
    'fused') serves the CPU plain run's outcomes: equal decisions, flags
    and iterations, brackets to 1e-12, in submission order."""
    from repro_torch.serve import BIFEngine
    a, reqs, lam = _engine_traffic()
    sv = BIFSolver.create(max_iters=220, rtol=1e-6, backend=backend)
    runs = {}
    kernel = "gql_update" if backend == "pallas" else "fused_step_dense"
    for dev in (torch.device("cpu"), cuda):
        eng = BIFEngine(Dense(torch.tensor(a, device=dev)), solver=sv,
                        max_batch=64, chunk_iters=8, **lam)
        before = ops.LAUNCHES[kernel]
        sub = [eng.submit(r()) for r in reqs]
        out = eng.flush(mode=mode)
        assert all(x is y for x, y in zip(out, sub)) and len(out) == len(sub)
        runs[dev.type] = (out, ops.LAUNCHES[kernel] - before)
    (cpu, cpu_launches), (card, card_launches) = runs["cpu"], runs["cuda"]
    assert cpu_launches == 0 and card_launches > 0
    for i, (g, w) in enumerate(zip(card, cpu)):
        assert (g.decision, g.certified, g.resolved, g.iterations) == \
            (w.decision, w.certified, w.resolved, w.iterations), i
        np.testing.assert_allclose([g.lower, g.upper], [w.lower, w.upper],
                                   rtol=1e-12, err_msg=str(i))
        assert g.resolved


@pytest.mark.parametrize("backend", ["reference", "pallas", "fused"])
def test_banked_partial_resumes_bit_exactly_on_the_card(cuda, backend):
    """A partial banked from slot 3 of a pool on the card (a clone of its
    lane) resumes, after other traffic has stepped the pool and with 40
    requests ahead of it in the queue, in slot 3 again (on the card a
    lane's bits depend on its slot) and to the bits of an uninterrupted
    run in that slot."""
    from repro_torch.serve import BIFEngine, BIFRequest
    a, reqs, lam = _engine_traffic(n=161, count=40, seed=71)
    op = Dense(torch.tensor(a, device=cuda))
    sv = BIFSolver.create(max_iters=170, rtol=1e-10, backend=backend)
    u = np.random.default_rng(72).standard_normal(a.shape[0])
    whole = BIFEngine(op, solver=sv, max_batch=64, **lam)
    for r in reqs[:3]:
        whole.submit(r())
    want = whole.submit(BIFRequest(u=u))
    whole.flush()
    eng = BIFEngine(op, solver=sv, max_batch=64, chunk_iters=8, **lam)
    for r in reqs[:3]:
        eng.submit(r())
    part = eng.submit(BIFRequest(u=u, max_iters=5))
    for r in reqs[3:]:
        eng.submit(r())
    eng.flush()
    assert part.resolved is False and part.iterations == 5
    assert part.state.st.lz.v.device.type == "cuda"
    for r in reqs:
        eng.submit(r())
    part.max_iters = None
    eng.submit(part)
    eng.flush()
    assert (part.lower, part.upper, part.iterations) == \
        (want.lower, want.upper, want.iterations)


def test_span_block_until_ready_synchronises_only_while_live(cuda,
                                                            monkeypatch):
    from repro_torch import obs
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device) or
                        real(device))
    x = torch.ones(8, device=cuda)
    try:
        obs.spans.set_enabled(False)
        with obs.span("off") as sp:
            assert sp.block_until_ready((x, x)) is not None
        assert calls == []
        obs.spans.set_enabled(True)
        with obs.span("on") as sp:
            sp.block_until_ready({"a": x, "b": [x.cpu()]})
            assert len(calls) == 1 and calls[0].type == "cuda"
            sp.block_until_ready(torch.ones(2))   # CPU tensors: no sync
            assert len(calls) == 1
        sp.block_until_ready(x)                   # the span has closed
        assert len(calls) == 1
    finally:
        obs.spans.set_enabled(False)
        obs.spans.reset()


# -- lanes over a mesh on the card (core/sharded.py) -------------------------

def _sharded_problem(n=500, k=16, seed=71):
    a = _spd(n, seed, kappa=50.0)
    us = np.random.default_rng(seed + 1).standard_normal((k, n))
    w = np.linalg.eigvalsh(a)
    return a, us, dict(lam_min=float(w[0] * 0.99),
                       lam_max=float(w[-1] * 1.01))


@pytest.fixture
def nccl_unit_mesh(cuda, tmp_path):
    """An NCCL group of one in this process and its lane mesh."""
    import torch.distributed as dist
    from repro_torch.launch import init_lane_group, make_lane_mesh
    init_lane_group("nccl", 0, 1, store=dist.FileStore(
        str(tmp_path / "store"), 1), timeout_s=60.0)
    try:
        yield make_lane_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("backend,kernel", [("pallas", "gql_update"),
                                            ("fused", "fused_step_dense")])
def test_nccl_unit_world_matches_one_device(nccl_unit_mesh, backend,
                                            kernel):
    """At D = 1 on NCCL the sharded drive runs the single-device shapes:
    the same bits, one gather a round plus two, the kernel launched."""
    from repro_torch.core import sharded
    a, us, lam = _sharded_problem()
    op = Dense(torch.tensor(a, device="cuda"))
    u = torch.tensor(us, device="cuda")
    s = BIFSolver.create(max_iters=120, rtol=1e-6, backend=backend)
    want = s.solve_batch(op, u, **lam)
    sharded.reset_counts()
    before = ops.LAUNCHES[kernel]
    got = s.solve_batch_sharded(op, u, mesh=nccl_unit_mesh, **lam)
    assert ops.LAUNCHES[kernel] > before
    c = sharded.COUNTS
    assert c["gathers"] == c["rounds"] + 2 and c["rounds"] > 0, c
    for f in ("lower", "upper", "iterations", "certified", "converged"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    am = s.judge_argmax_sharded(op, u, mesh=nccl_unit_mesh, **lam)
    aw = s.judge_argmax(op, u, **lam)
    assert int(am.index) == int(aw.index) and bool(am.certified)


def _gloo_rank(rank, world, store, out):
    """One gloo rank sharing cuda:0 (test_two_gloo_ranks_share_the_card):
    a sharded 'pallas' solve, its result and collective counts pickled to
    ``out``."""
    import pickle

    import torch.distributed as dist
    from repro_torch.core import sharded
    from repro_torch.launch import init_lane_group, make_lane_mesh
    init_lane_group("gloo", rank, world, store=dist.FileStore(store, world),
                    timeout_s=60.0)
    try:
        mesh = make_lane_mesh()
        a, us, lam = _sharded_problem()
        s = BIFSolver.create(max_iters=120, rtol=1e-6, backend="pallas")
        before = ops.LAUNCHES["gql_update"]
        sharded.reset_counts()
        res = s.solve_batch_sharded(Dense(torch.tensor(a, device="cuda")),
                                    torch.tensor(us, device="cuda"),
                                    mesh=mesh, **lam)
        rec = {f: getattr(res, f).cpu().numpy() for f in (
            "lower", "upper", "iterations", "certified")}
        rec.update(counts=dict(sharded.COUNTS),
                   launches=ops.LAUNCHES["gql_update"] - before)
    finally:
        dist.destroy_process_group()
    with open(f"{out}{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0 (the round's scalars through host memory):
    each launches K1 on its lanes, pays one gather a round plus two, and
    returns the single-device outcome (iterations within 1, the same
    certification, brackets around each other within the rtol)."""
    import multiprocessing as mp
    import pickle
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(
        r, 2, str(tmp_path / "store"), str(tmp_path / "rank")))
        for r in range(2)]
    for q in procs:
        q.start()
    for q in procs:
        q.join(120.0)
    alive = [q for q in procs if q.is_alive()]
    for q in alive:
        q.kill()
    assert not alive and [q.exitcode for q in procs] == [0, 0]
    recs = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            recs.append(pickle.load(f))
    a, us, lam = _sharded_problem()
    want = BIFSolver.create(max_iters=120, rtol=1e-6, backend="pallas") \
        .solve_batch(Dense(torch.tensor(a, device=cuda)),
                     torch.tensor(us, device=cuda), **lam)
    for rec in recs:
        c = rec["counts"]
        assert rec["launches"] > 0
        assert c["gathers"] == c["rounds"] + 2 and c["rounds"] > 0, c
        for f in ("lower", "upper", "iterations", "certified"):
            np.testing.assert_array_equal(rec[f], recs[0][f])
    it_w = want.iterations.cpu().numpy()
    assert np.abs(recs[0]["iterations"] - it_w).max() <= 1
    np.testing.assert_array_equal(recs[0]["certified"],
                                  want.certified.cpu().numpy())
    np.testing.assert_allclose(recs[0]["lower"], want.lower.cpu().numpy(),
                               rtol=1e-6)


def test_rank_local_engine_flush_on_the_card(nccl_unit_mesh):
    """BIFEngine(mesh=) at D = 1: the pool's slots are the rank's, each
    round's per-lane results and the clock are gathered, and the flush
    serves the single-device engine's outcomes bit for bit."""
    from repro_torch.core import sharded
    from repro_torch.serve import BIFEngine
    a, reqs, lam = _engine_traffic()
    sv = BIFSolver.create(max_iters=220, rtol=1e-6, backend="pallas")
    runs = []
    for mesh in (None, nccl_unit_mesh):
        sharded.reset_counts()
        eng = BIFEngine(Dense(torch.tensor(a, device="cuda")), solver=sv,
                        max_batch=64, chunk_iters=8, mesh=mesh, **lam)
        sub = [eng.submit(r()) for r in reqs]
        out = eng.flush()
        assert len(out) == len(sub) and all(x is y for x, y in zip(out, sub))
        runs.append((sub, dict(sharded.COUNTS), eng.stats()["counters"]))
    (one, c1, s1), (mesh, c2, s2) = runs
    assert c1["gathers"] == 0 and c2["clocks"] > 0 and c2["rounds"] > 0
    assert c2["gathers"] == c2["boundaries"] + c2["finalizes"] + c2["clocks"]
    assert s1 == s2
    for i, (g, w) in enumerate(zip(mesh, one)):
        assert (g.decision, g.certified, g.resolved, g.iterations, g.lower,
                g.upper) == (w.decision, w.certified, w.resolved,
                             w.iterations, w.lower, w.upper), i


# -- the training path (no kernel: the model, optimizer, checkpoints and
# monitor on the card against the port's CPU path)


def _small_lm(dtype="float32"):
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("olmo-1b").reduced(), dtype=dtype)


@pytest.mark.parametrize("fsdp,mb", [(False, 1), (True, 2)])
def test_nccl_unit_mesh_train_step_matches_one_device(cuda, tmp_path, fsdp,
                                                     mb):
    """Two f32 train steps of reduced olmo-1b over a (1, 1) mesh on an
    NCCL group of one (DTensor parameters and moments, the forward under
    ``activation_context``) against the one-device step on the card: loss
    within 2e-5, parameters within 1e-5 and first moments within 1e-4 of
    each leaf's largest entry (AdamW at eps 1e-3)."""
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.launch import init_lane_group, make_host_mesh, steps
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW
    from repro_torch.sharding import api as shapi
    cfg = _small_lm()
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 33)).astype(
        np.int32)
    batch = {"tokens": torch.tensor(toks[:, :-1], device=cuda),
             "labels": torch.tensor(toks[:, 1:], device=cuda)}
    opt = AdamW(lr=1e-2, eps=1e-3)
    params, axes = M.init_model(0, cfg, device=cuda)
    one = tree.map(lambda x: x.clone(), params)
    init_lane_group("nccl", 0, 1, store=dist.FileStore(
        str(tmp_path / "store"), 1), timeout_s=60.0)
    try:
        mesh = make_host_mesh(device_type="cuda")
        plan = shapi.tp_plan(data_axes=("data",), fsdp=fsdp)
        dp = shapi.distribute(params, mesh, shapi.param_shardings(
            plan, mesh, params, axes))
        par = steps.build_train_step(cfg, mesh, plan, opt, microbatches=mb)
        ref = steps.build_train_step(cfg, optimizer=opt, microbatches=mb)
        ds, os_ = opt.init(dp), opt.init(one)
        for _ in range(2):
            dp, ds, dm = par(dp, ds, batch)
            one, os_, om = ref(one, os_, batch)
            assert abs(float(dm["loss"]) - float(om["loss"])) <= \
                2e-5 * abs(float(om["loss"]))
        for got, want, tol in ((dp, one, 1e-5), (ds.m, os_.m, 1e-4)):
            for a, b in zip(tree.leaves(got), tree.leaves(want)):
                a = a.full_tensor()
                assert a.is_cuda
                assert (a - b).abs().max() <= tol * b.abs().max()
    finally:
        dist.destroy_process_group()


def test_train_step_on_the_card_matches_cpu(cuda):
    """One train step (microbatches 1 and 2) of reduced olmo-1b in f32 on
    the card against the same step on the CPU: loss within 1e-5, the
    updated parameters within 1e-5 of their largest entry (AdamW at
    eps 1e-3, see tests/test_torch_train.py); in bf16 the parameters stay
    bf16 and the moments f32."""
    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW
    cfg = _small_lm()
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 33)).astype(
        np.int32)
    for mb in (1, 2):
        outs = []
        for dev in ("cpu", cuda):
            p, _ = M.init_model(0, cfg, device="cpu")
            p = tree.map(lambda x: x.to(dev), p)
            opt = AdamW(lr=1e-2, eps=1e-3)
            batch = {"tokens": torch.tensor(toks[:, :-1], device=dev),
                     "labels": torch.tensor(toks[:, 1:], device=dev)}
            p, _, m = steps.build_train_step(cfg, optimizer=opt,
                                             microbatches=mb)(
                p, opt.init(p), batch)
            outs.append((float(m["loss"]), [x.cpu() for x in tree.leaves(p)]))
        (l_cpu, p_cpu), (l_dev, p_dev) = outs
        assert abs(l_dev - l_cpu) <= 1e-5 * l_cpu
        for a, b in zip(p_dev, p_cpu):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    c16 = _small_lm("bfloat16")
    p, _ = M.init_model(1, c16, device=cuda)
    opt = AdamW(lr=1e-2)
    st = opt.init(p)
    batch = {"tokens": torch.tensor(toks[:, :-1], device=cuda),
             "labels": torch.tensor(toks[:, 1:], device=cuda)}
    p, st, m = steps.build_train_step(c16, optimizer=opt)(p, st, batch)
    assert torch.isfinite(m["loss"])
    assert all(x.dtype == torch.bfloat16 and x.is_cuda
               for x in tree.leaves(p))
    assert all(x.dtype == torch.float32 for x in tree.leaves(st.m))


def test_checkpoint_bf16_roundtrip_on_the_card(cuda, tmp_path):
    """Every bf16 bit pattern of a card tensor is written as its 16-bit
    word and restored onto the card unchanged; the async saver copies the
    leaves off the card before an in-place update can reach them."""
    from repro_torch.checkpoint import io
    words = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16)
    t = {"w": words.view(torch.bfloat16).reshape(256, 256).to(cuda),
         "m": torch.randn(7, 5, device=cuda)}
    want = {k: v.clone() for k, v in t.items()}
    saver = io.AsyncSaver()
    saver.save(tmp_path, 1, t)
    for v in t.values():
        v.add_(1)
    saver.wait()
    got = io.restore(tmp_path, 1, t)
    assert got["w"].is_cuda and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), want["w"].view(torch.int16))
    assert torch.equal(got["m"], want["m"])


def test_monitor_draws_on_the_card(cuda):
    """The sketch's counter-based draws: the integer hash is exact on
    either device, so the card's draws match the CPU's to the erfinv's
    rounding (1e-6), and blocked draws equal the whole on the card."""
    from repro_torch.train import monitor
    whole = monitor.projection(7, 3, 16, 0, 100_003, cuda)
    blocked = torch.cat([monitor.projection(7, 3, 16, a, b, cuda)
                         for a, b in ((0, 5), (5, 65_536), (65_536, 100_003))],
                        dim=1)
    assert torch.equal(whole, blocked)
    cpu = monitor.projection(7, 3, 16, 0, 100_003)
    assert (whole.cpu() - cpu).abs().max() <= 1e-6 * cpu.abs().max()


# -- the serving path of the LM (no kernel: KV caches, prefill, decode and
# the Engine on the card against the port's CPU path)


def _served(cfg, dev, quantized, temperature=0.0):
    """A reduced model's Engine on ``dev``: the tokens of three requests of
    mixed lengths, and each step's logits (``_sample`` wrapped)."""
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, Request
    p, _ = M.init_model(0, cfg, device="cpu")
    draws = torch.Generator().manual_seed(5)

    def gumbel(shape):   # drawn on the host: the same draws on each device
        e = torch.empty(shape).exponential_(generator=draws)
        return -torch.log(e).to(dev)

    eng = Engine(cfg, tree.map(lambda x: x.to(dev), p), max_batch=4,
                 max_seq=40, quantized_kv=quantized, gumbel=gumbel)
    logits = []
    real = eng._sample

    def sample(lg, t):
        logits.append(lg.cpu())
        return real(lg, t)

    eng._sample = sample
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab - 1, n).astype(
                np.int32), max_new_tokens=m, temperature=temperature)
            for n, m in ((9, 8), (17, 6), (4, 8))]
    eng.generate(reqs)
    return [r.out_tokens for r in reqs], logits


@pytest.mark.parametrize("quantized", [False, True])
def test_engine_on_the_card_matches_cpu(cuda, quantized):
    """Reduced olmo-1b in f32, f32 and int8 caches: the card's logits at
    every step within 1e-5 relative of the CPU's (int8: 1e-2, bf16
    dequantised values in another order) and the same greedy tokens; at
    T = 1 with the same draws, the same tokens."""
    cfg = _small_lm()
    tol = 1e-2 if quantized else 1e-5
    for temperature in (0.0, 1.0):
        (t_cpu, l_cpu), (t_dev, l_dev) = (
            _served(cfg, d, quantized, temperature) for d in ("cpu", cuda))
        assert len(l_cpu) == len(l_dev) == 8
        for a, b in zip(l_dev, l_cpu):
            assert (a - b).abs().max() <= tol * b.abs().max()
        for a, b in zip(t_dev, t_cpu):
            np.testing.assert_array_equal(a, b)


def test_int8_caches_on_the_card(cuda):
    """int8 caches written on the card: the codes and scales of the card's
    prefill equal the CPU's within one code (the projections round in
    another order), lengths equal, and prefill logits equal the f32
    cache's (prefill attends the fresh k / v)."""
    from repro_torch import tree
    from repro_torch.models import model as M
    cfg = _small_lm("bfloat16")
    p, _ = M.init_model(0, cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (3, 24)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        pd = tree.map(lambda x: x.to(dev), p)
        c8 = M.make_caches(cfg, 3, 32, quantized_kv=True, device=dev)
        c8, l8 = M.prefill(cfg, pd, {"tokens": toks.to(dev)}, c8)
        c32 = M.make_caches(cfg, 3, 32, torch.float32, device=dev)
        _, l32 = M.prefill(cfg, pd, {"tokens": toks.to(dev)}, c32)
        assert torch.equal(l8, l32)
        assert c8.k.dtype == torch.int8 and c8.k.device.type == \
            torch.device(dev).type
        out[dev] = [x.cpu() for x in c8]
    for i, (a, b) in enumerate(zip(out[cuda], out["cpu"])):
        if a.dtype == torch.int8:
            assert (a.int() - b.int()).abs().max() <= 1, i
        elif i == 2:
            assert torch.equal(a, b)
        else:
            assert (a - b).abs().max() <= 2e-2 * b.abs().max(), i


# -- the MoE and SSM families served (no kernel: the layers and the Engine
# on the card against the port's CPU path)


def _family(name, **changes):
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(name).reduced(), **changes)


@pytest.mark.parametrize("name", ["arctic-480b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_apply_on_the_card_matches_cpu(cuda, name, dropless):
    """``moe_apply`` at capacity 0.5 (drops) and dropless, f32: the same
    dispatch masks, y within 1e-5 and aux within 1e-6 relative."""
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.models import moe
    cfg = _family(name, moe_capacity_factor=0.5)
    p, _ = M.init_model(0, cfg, device="cpu")
    units = p["units"]
    blk = tree.map(lambda x: x[0], units[sorted(units)[-1]]["moe"])
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (3, 40, cfg.d_model)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        bd = tree.map(lambda t: t.to(dev), blk)
        r = moe._route(cfg, bd, x.to(dev), dropless=dropless)
        y, aux = moe.moe_apply(cfg, bd, x.to(dev), dropless=dropless)
        out[dev] = (r.dispatch.cpu(), y.cpu(), aux.cpu())
    (dc, yc, ac), (dd, yd, ad) = out["cpu"], out[cuda]
    assert torch.equal(dd, dc)
    if not dropless:   # capacity 0.5 drops
        assert float(dc.sum()) < 120 * cfg.moe_top_k
    assert (yd - yc).abs().max() <= 1e-5 * yc.abs().max()
    assert abs(float(ad) - float(ac)) <= 1e-6 * abs(float(ac))


@pytest.mark.parametrize("name,impl", [("falcon-mamba-7b", "scan"),
                                       ("zamba2-1.2b", "scan"),
                                       ("zamba2-1.2b", "chunked")])
def test_ssm_apply_on_the_card_matches_cpu(cuda, name, impl):
    """``ssm_apply`` prefill then two decode steps, f32, the caches written
    in place on each device: outputs and states within 1e-5 relative."""
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    cfg = _family(name, ssm_impl=impl)
    gen = torch.Generator().manual_seed(0)
    p, _ = ssm.ssm_init(M._drawer(gen), cfg, torch.float32)
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32) * 0.3)
    out = {}
    for dev in ("cpu", cuda):
        pd = tree.map(lambda t: t.to(dev), p)
        c = ssm.make_ssm_cache(cfg, 2, torch.float32, device=dev)
        ys = [ssm.ssm_apply(cfg, pd, x[:, :10].to(dev), mode="prefill",
                            cache=c)[0]]
        for i in (10, 11):
            ys.append(ssm.ssm_apply(cfg, pd, x[:, i:i + 1].to(dev),
                                    mode="decode", cache=c)[0])
        out[dev] = [y.cpu() for y in ys] + [c.state.cpu(), c.conv.cpu()]
    for a, b in zip(out[cuda], out["cpu"]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def _family_batches(cfg, toks, seed=11):
    """The prefill batch of ``toks[:, :-1]`` and the decode batch of its
    last token, on the CPU, with the family's other inputs: a VLM's 4 patch
    embeddings first and distinct M-RoPE streams (a 2 x 2 grid at (0, row,
    col), text from 2 onward on all three), an enc-dec model's 7 frames
    (the decode step's ``enc_memory`` is left to the caller)."""
    b, t = toks.shape
    rng = np.random.default_rng(seed)
    pre = {"tokens": toks[:, :-1]}
    dec = {"tokens": toks[:, -1:],
           "position": torch.full((1,), t - 1, dtype=torch.int32)}
    if cfg.family == "vlm":
        rows, cols = np.divmod(np.arange(4), 2)
        text = np.arange(2, 2 + t)
        pos = np.stack([np.r_[np.zeros(4, int), text], np.r_[rows, text],
                        np.r_[cols, text]])
        pos = torch.as_tensor(np.broadcast_to(pos, (b, 3, 4 + t)).astype(
            np.int32))
        pre["vision_embeds"] = torch.as_tensor(rng.standard_normal(
            (b, 4, cfg.d_model)).astype(np.float32))
        pre["positions"] = pos[:, :, :-1]
        dec["position"] = pos[:, :, -1:]
    if cfg.family == "encdec":
        pre["frames"] = torch.as_tensor(rng.standard_normal(
            (b, 7, cfg.d_model)).astype(np.float32))
    return pre, dec


@pytest.mark.parametrize("name", ["arctic-480b", "llama4-maverick-400b-a17b",
                                  "falcon-mamba-7b", "zamba2-1.2b",
                                  "whisper-medium", "qwen2-vl-2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_family_decode_step_on_the_card_matches_cpu(cuda, name, dtype):
    """Prefill and one decode step of each family with f32 caches, f32 and
    bf16 weights (the Engine's default cache): logits within 1e-5 (f32)
    or 2e-2 (bf16: the projections round in another order) of the CPU's,
    and the Engine's greedy tokens equal in f32 (the families it serves:
    not enc-dec nor VLM, whose batches it does not build). zamba2 runs 5
    layers (a tail of 1) with a window of 8 over its 14 tokens; whisper's
    decode step takes ``_encode`` of the frames; qwen2-vl's positions are
    (B, 3, 1)."""
    from repro_torch import tree
    from repro_torch.models import model as M
    changes = dict(n_layers=5, attn_window=8) if name == "zamba2-1.2b" \
        else {}
    cfg = _family(name, dtype=dtype, **changes)
    p, _ = M.init_model(0, cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(10).integers(
        1, cfg.vocab, (3, 14)).astype(np.int32))
    pre, dec = _family_batches(cfg, toks)
    out = {}
    for dev in ("cpu", cuda):
        pd = tree.map(lambda x: x.to(dev), p)
        c = M.make_caches(cfg, 3, 20, torch.float32, device=dev)
        c, l_pre = M.prefill(cfg, pd, {k: v.to(dev) for k, v in pre.items()},
                             c)
        d = {k: v.to(dev) for k, v in dec.items()}
        if cfg.family == "encdec":
            d["enc_memory"] = M._encode(cfg, pd, pre["frames"].to(dev).to(
                pd["embed"]["table"].dtype))
        _, l_dec = M.decode_step(cfg, pd, c, d)
        out[dev] = (l_pre.cpu(), l_dec.cpu())
    tol = 1e-5 if dtype == "float32" else 2e-2
    for a, b in zip(out[cuda], out["cpu"]):
        assert (a - b).abs().max() <= tol * b.abs().max()
    if dtype == "float32" and cfg.family not in ("encdec", "vlm"):
        (t_cpu, _), (t_dev, _) = (_served(cfg, d, False) for d in
                                  ("cpu", cuda))
        for a, b in zip(t_dev, t_cpu):
            np.testing.assert_array_equal(a, b)


def test_shared_block_caches_per_unit_on_the_card(cuda):
    """zamba2's one shared attention block writes a KV cache per unit: on
    the card, after a prefill and a decode step, each unit's k / v equal
    the CPU's (1e-5, f32) and the units' differ from each other."""
    from repro_torch import tree
    from repro_torch.models import model as M
    cfg = _family("zamba2-1.2b", dtype="float32", n_layers=6)
    p, _ = M.init_model(0, cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        1, cfg.vocab, (2, 11)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        pd = tree.map(lambda x: x.to(dev), p)
        c = M.make_caches(cfg, 2, 12, torch.float32, device=dev)
        c, _ = M.prefill(cfg, pd, {"tokens": toks[:, :-1].to(dev)}, c)
        M.decode_step(cfg, pd, c, {
            "tokens": toks[:, -1:].to(dev),
            "position": torch.full((1,), 10, dtype=torch.int32, device=dev)})
        out[dev] = tree.map(lambda x: x.cpu(), c["units"]["attn"])
    got, want = out[cuda], out["cpu"]
    assert got.k.shape[0] == 3 and got.length.tolist() == [11] * 3
    for u in range(3):
        for a, b in ((got.k[u], want.k[u]), (got.v[u], want.v[u])):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max(), u
    for u in (1, 2):
        assert (got.k[u] - got.k[0]).abs().max() > 0.1 * got.k[0].abs().max()
