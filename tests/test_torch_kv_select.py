"""The port's KV-cache block selection (serve/kv_select.py) against the
JAX package's on the same seeded numpy keys (the plain kernels on the
CPU).

Twins of tests/test_substrates.py (diversity, near-duplicate ranking),
tests/test_batched.py::test_rank_blocks_same_bucket_compiles_once and the
streaming ``BlockRanker`` / tail-block tests of tests/test_update.py.
Selections, resolved / certified counts and iteration counts are equal;
orders agree wherever two blocks' brackets are disjoint (the ranking
sorts bracket midpoints, so blocks whose brackets overlap are a tie the
certification leaves open). The kernels here are f32 (both packages build the block kernel in
f32), so brackets are held to f32 roundoff amplified by the interval's
conditioning, ``F32_RTOL``, not to the f64 parity's 1e-12. The reference's
``jax.random`` uniforms of ``select_diverse_blocks`` are replayed through
the port's ``uniforms`` table.

The port's rankers take the ridge as the lower end of their interval
(``kv_select._lam_min``) where the reference takes the engine's
Gershgorin floor, on which its f32 brackets can come back inverted (a
fault of the reference, ROADMAP Queue 3;
``test_reference_gershgorin_interval_inverts_f32_brackets`` pins both).
So the ranking parity holds the port against the reference's
``rank_blocks`` with its engine given that same lower end."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as RS  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
from repro.core.solver import SolverConfig as RConfig  # noqa: E402
from repro.serve import kv_select as rkv  # noqa: E402
from repro_torch.core import SolverConfig  # noqa: E402
from repro_torch.serve import kv_select as tkv  # noqa: E402

# f32 brackets: 2^-24 relative roundoff of the two packages' matvecs, with
# room for the Radau ends' amplification on these ridge-1e-3 kernels
F32_RTOL = 1e-4


def _uniforms(seed, n):
    """The reference double greedy's per-item uniforms from its key
    (double_greedy.py:50, 61)."""
    keys = jax.random.split(jax.random.key(seed), n)
    return torch.tensor([np.float32(jax.random.uniform(k, (), jnp.float32))
                         for k in keys])


@pytest.fixture
def ref_rank_blocks(monkeypatch):
    """The reference's ``rank_blocks`` with its engine given the port's
    lower spectral end, ridge / 2."""
    def run(keys, *, ridge=1e-3, **kw):
        monkeypatch.setattr(rkv, "BIFEngine", functools.partial(
            RS.BIFEngine, lam_min=tkv._lam_min(ridge)))
        try:
            return RS.rank_blocks(keys, ridge=ridge, **kw)
        finally:
            monkeypatch.undo()
    return run


def _truths(keys, block, ridge=1e-3, bandwidth=0.5):
    """Each block's leverage against the others, K_ii - 1 / (K^-1)_ii, in
    f64 from the f32 kernel both packages solve."""
    k = tkv._rbf_kernel(tkv.pool_keys(keys, block), ridge, bandwidth)
    k = k.astype(np.float32).astype(np.float64)
    return np.diag(k) - 1.0 / np.diag(np.linalg.inv(k))


def _contain(brackets, truth):
    b = np.array(brackets, float)
    tol = F32_RTOL * np.abs(truth)
    return (b[:, 0] <= truth + tol) & (b[:, 1] >= truth - tol)


def _brackets_close(got, want):
    np.testing.assert_allclose(np.array(got, float), np.array(want, float),
                               rtol=F32_RTOL)


def _same_order_where_separated(order, brackets, want_order,
                                want_brackets):
    """Every pair of blocks whose brackets are disjoint by more than the
    f32 tolerance (in the reference; then they are disjoint in the port
    too) comes in the same order in both packages; returns how many pairs
    were separated. Closer pairs are ties at f32 roundoff."""
    b, w = np.array(brackets, float), np.array(want_brackets, float)
    gap = F32_RTOL * np.abs(w).max()
    pos = np.empty(len(order), int)
    pos[np.asarray(order)] = np.arange(len(order))
    wpos = np.empty(len(want_order), int)
    wpos[np.asarray(want_order)] = np.arange(len(want_order))
    pairs = 0
    for i in range(len(b)):
        for j in range(len(b)):
            if i != j and w[i, 0] - w[j, 1] > gap:  # i more redundant
                assert b[i, 0] > b[j, 1], (i, j)
                assert wpos[i] < wpos[j] and pos[i] < pos[j], (i, j)
                pairs += 1
    return pairs


def test_pool_keys_and_kernel_equal_the_reference():
    rng = np.random.default_rng(0)
    keys = rng.standard_normal((10, 4)).astype(np.float32)
    p = TS.pool_keys(keys, block=4)
    np.testing.assert_array_equal(p, RS.pool_keys(keys, block=4))
    assert p.shape == (3, 4)             # ceil(10/4), not floor
    tail = keys[8:].mean(0)
    np.testing.assert_allclose(p[2], tail / (np.linalg.norm(tail) + 1e-8),
                               atol=1e-6)
    from repro.serve.kv_select import _rbf_kernel as r_rbf
    from repro_torch.serve.kv_select import _rbf_kernel as t_rbf
    np.testing.assert_array_equal(t_rbf(p, 1e-3, 0.5), r_rbf(p, 1e-3, 0.5))


def test_kv_select_diversity():
    rng = np.random.default_rng(0)
    # two clusters of keys: diverse selection should cover both
    c1 = rng.standard_normal((512, 16)) * 0.05 + 1.0
    c2 = rng.standard_normal((512, 16)) * 0.05 - 1.0
    keys = np.concatenate([c1, c2]).astype(np.float32)
    mask, stats = TS.select_diverse_blocks(keys, block=64, device="cpu")
    assert stats["uncertified"] == 0
    half = len(mask) // 2
    assert mask[:half].sum() >= 1 and mask[half:].sum() >= 1
    # the reference's draws, replayed: the same selection and counts
    rmask, rstats = RS.select_diverse_blocks(keys, block=64, seed=3)
    gmask, gstats = TS.select_diverse_blocks(
        keys, block=64, uniforms=_uniforms(3, len(rmask)), device="cpu")
    assert np.array_equal(gmask, rmask)
    for k in ("quad_iterations", "uncertified", "kept", "blocks"):
        assert gstats[k] == rstats[k], k
    np.testing.assert_allclose(gstats["log_det"], rstats["log_det"],
                               rtol=1e-5)


def _near_duplicate_keys():
    rng = np.random.default_rng(3)
    block, n, d = 4, 6, 8
    dirs = rng.standard_normal((n, d))
    dirs[-1] = dirs[0] + 0.01 * rng.standard_normal(d)  # near-duplicate pair
    keys = np.repeat(dirs, block, axis=0).astype(np.float32)
    keys += 0.001 * rng.standard_normal(keys.shape).astype(np.float32)
    return keys, block, n


def test_kv_rank_blocks_flags_near_duplicate_as_redundant(ref_rank_blocks):
    keys, block, n = _near_duplicate_keys()
    order, stats = TS.rank_blocks(keys, block=block, max_batch=4,
                                  device="cpu")
    assert order[0] in (0, n - 1)
    mids = np.array([0.5 * (lo + hi) for lo, hi in stats["brackets"]])
    rest = [i for i in range(1, n - 1)]
    assert min(mids[0], mids[-1]) > mids[rest].max() + 0.1
    assert _contain(stats["brackets"], _truths(keys, block)).all()
    rorder, rstats = ref_rank_blocks(keys, block=block, max_batch=4)
    assert _same_order_where_separated(order, stats["brackets"], rorder,
                                       rstats["brackets"])
    for k in ("iterations", "certified", "resolved", "refined", "flushes",
              "blocks"):
        assert stats[k] == rstats[k], k
    _brackets_close(stats["brackets"], rstats["brackets"])


def test_reference_gershgorin_interval_inverts_f32_brackets():
    """The reference fault the port's ``_lam_min`` repairs: on the f32
    kernel, with the engine's Gershgorin floor lam_min = 1e-9 lam_max, the
    reference certifies a block of the near-duplicate keys with an
    inverted bracket (its upper end far below zero, the truth outside);
    the port brackets every truth."""
    keys, block, _ = _near_duplicate_keys()
    truth = _truths(keys, block)
    _, rstats = RS.rank_blocks(keys, block=block, max_batch=4)
    rb = np.array(rstats["brackets"])
    assert (rb[:, 1] < rb[:, 0]).any()
    assert not _contain(rstats["brackets"], truth).all()
    assert rstats["certified"] == len(rb)
    _, stats = TS.rank_blocks(keys, block=block, max_batch=4, device="cpu")
    b = np.array(stats["brackets"])
    assert _contain(stats["brackets"], truth).all()
    assert (b[:, 1] >= b[:, 0] - F32_RTOL * np.abs(truth)).all()


def _clustered_keys(nb, block, d, seed, clusters=None):
    """``nb`` blocks of ``block`` keys around ``clusters`` (default: one a
    block) separated centres."""
    r = np.random.default_rng(seed)
    clusters = nb if clusters is None else clusters
    centres = 3.0 * r.standard_normal((clusters, d))
    which = np.arange(nb) % clusters
    keys = centres[which].repeat(block, 0) \
        + 0.05 * r.standard_normal((nb * block, d))
    return keys.astype(np.float32)


@pytest.mark.parametrize("backend", ["reference", "pallas", "fused"])
@pytest.mark.parametrize("coarse", [None, 2])
def test_rank_blocks_matches_reference(ref_rank_blocks, coarse, backend):
    """Two-phase ranking (coarse budget, then banked resumes of the
    ambiguous blocks) orders as the reference does, on every backend
    (the plain K1 and K3 here), every bracket holding its truth."""
    keys = _clustered_keys(40, 8, 6, seed=5, clusters=10)
    cfg = dict(max_iters=20, rtol=1e-3)
    order, stats = TS.rank_blocks(keys, block=8, bucket=16, max_batch=16,
                                  solver_config=SolverConfig(
                                      **cfg, backend=backend),
                                  coarse_iters=coarse, device="cpu")
    assert _contain(stats["brackets"], _truths(keys, 8)).all()
    rorder, rstats = ref_rank_blocks(keys, block=8, bucket=16, max_batch=16,
                                     solver_config=RConfig(**cfg),
                                     coarse_iters=coarse)
    assert _same_order_where_separated(order, stats["brackets"], rorder,
                                       rstats["brackets"])
    for k in ("iterations", "certified", "resolved", "refined", "flushes"):
        assert stats[k] == rstats[k], k
    _brackets_close(stats["brackets"], rstats["brackets"])
    if coarse is not None:
        assert stats["refined"] > 0


def test_rank_blocks_same_bucket_compiles_once():
    """Distinct block counts in one padding bucket share ONE driver
    signature: the second call meets no new one."""
    rng = np.random.default_rng(11)
    keys_a = rng.standard_normal((24 * 4, 8)).astype(np.float32)  # 24 blocks
    keys_b = rng.standard_normal((20 * 4, 8)).astype(np.float32)  # 20 blocks
    kw = dict(block=4, max_batch=8, bucket=32, device="cpu")
    order_a, stats_a = TS.rank_blocks(keys_a, **kw)
    first = TS.flush_trace_count()
    order_b, stats_b = TS.rank_blocks(keys_b, **kw)
    assert TS.flush_trace_count() == first, \
        "second rank_blocks call in the same bucket met a new signature"
    TS.rank_blocks(keys_a, **kw)
    assert TS.flush_trace_count() == first
    assert sorted(order_a.tolist()) == list(range(24))
    assert sorted(order_b.tolist()) == list(range(20))
    assert stats_a["blocks"] == 24 and stats_b["blocks"] == 20
    assert len(stats_b["brackets"]) == 20


_BLOCK, _DIM = 8, 6


def _cluster(scale, seed, nb=1, jitter=0.02):
    r = np.random.default_rng(seed)
    c = scale * r.standard_normal((1, _DIM))
    return (c + jitter * r.standard_normal((nb * _BLOCK, _DIM))) \
        .astype(np.float32)


def _cfgs():
    return dict(solver_config=SolverConfig(max_iters=34, rtol=1e-3)), \
        dict(solver_config=RConfig(max_iters=34, rtol=1e-3))


def test_block_ranker_matches_reference_ranker_on_one_call(ref_rank_blocks):
    """A first ``rank()`` is a cold ranking: the same as the reference's
    ``rank_blocks`` on the same keys (with the port's lower end)."""
    keys = np.concatenate([_cluster(3.0, s) for s in range(6)])
    tcfg, rcfg = _cfgs()
    order, info = TS.BlockRanker(block=_BLOCK, bucket=8, device="cpu",
                                 **tcfg).extend(keys).rank()
    rorder, rstats = ref_rank_blocks(keys, block=_BLOCK, bucket=8, **rcfg)
    assert _same_order_where_separated(order, info["brackets"], rorder,
                                       rstats["brackets"])
    assert info["iterations"] == rstats["iterations"]
    _brackets_close(info["brackets"], rstats["brackets"])


@pytest.mark.parametrize("coarse", [None, 2])
def test_block_ranker_first_call_matches_rank_blocks(coarse):
    keys = np.concatenate([_cluster(3.0, s) for s in range(6)])
    tcfg, _ = _cfgs()
    br = TS.BlockRanker(block=_BLOCK, bucket=8, coarse_iters=coarse,
                        device="cpu", **tcfg)
    order, info = br.extend(keys).rank()
    cold_order, cold = TS.rank_blocks(keys, block=_BLOCK, bucket=8,
                                      coarse_iters=coarse, device="cpu",
                                      **tcfg)
    assert np.array_equal(order, cold_order)
    assert np.array_equal(np.array(info["brackets"]),
                          np.array(cold["brackets"]))
    assert info["solved"] == info["blocks"] and info["reused"] == 0


def test_block_ranker_grown_cache_resolves_only_new_blocks():
    """The streaming ranker re-solves only the new block, meets no new
    driver signature, and ranks as a cold ``rank_blocks`` does."""
    keys0 = np.concatenate([_cluster(3.0, s) for s in range(5)])
    grown = _cluster(6.0, 99)    # far from every existing cluster
    tcfg, _ = _cfgs()
    br = TS.BlockRanker(block=_BLOCK, bucket=8, device="cpu", **tcfg)
    br.extend(keys0).rank()
    before = TS.flush_trace_count()
    order, info = br.extend(grown).rank()
    assert br.stats["engine_builds"] == 1
    assert TS.flush_trace_count() == before
    assert info["blocks"] == 6
    assert info["solved"] == 1 and info["reused"] == 5
    assert info["flushes"] == 1
    cold_order, cold = TS.rank_blocks(np.concatenate([keys0, grown]),
                                      block=_BLOCK, bucket=8, device="cpu",
                                      **tcfg)
    assert np.array_equal(order, cold_order)
    assert 0 < info["iterations"] < cold["iterations"]


def test_block_ranker_bucket_overflow_rebuilds_engine():
    tcfg, _ = _cfgs()
    br = TS.BlockRanker(block=_BLOCK, bucket=4, device="cpu", **tcfg)
    br.extend(np.concatenate([_cluster(3.0, s) for s in range(4)])).rank()
    assert br.stats["engine_builds"] == 1
    br.extend(_cluster(4.0, 41)).rank()   # 5 blocks > bucket of 4
    assert br.stats["engine_builds"] == 2


def test_block_ranker_partial_tail_block_is_rescored():
    keys0 = np.concatenate([_cluster(3.0, s) for s in range(2)]
                           + [_cluster(5.0, 9)[:_BLOCK // 2]])
    tcfg, _ = _cfgs()
    br = TS.BlockRanker(block=_BLOCK, bucket=8, device="cpu", **tcfg)
    _, info0 = br.extend(keys0).rank()
    assert info0["blocks"] == 3
    _, info1 = br.extend(_cluster(5.0, 9)[_BLOCK // 2:]).rank()
    assert info1["blocks"] == 3
    assert info1["solved"] >= 1
    with pytest.raises(ValueError, match="keys must be"):
        br.extend(np.ones(3))
    with pytest.raises(ValueError, match="no keys"):
        TS.BlockRanker(device="cpu").rank()


def test_apply_block_mask_equals_the_reference():
    ck = torch.arange(60, dtype=torch.float32).reshape(1, 10, 2, 3)
    cv = -ck
    for mask in (np.array([True, False, True]),
                 np.array([True, False, False]), np.array([True, False])):
        k2, v2 = TS.apply_block_mask(ck, cv, mask, block=4)
        rk, rv = RS.apply_block_mask(jnp.asarray(ck.numpy()),
                                     jnp.asarray(cv.numpy()), mask, block=4)
        np.testing.assert_array_equal(k2.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(v2.numpy(), np.asarray(rv))
        assert k2.dtype == ck.dtype


def test_rankers_refuse_a_mesh_until_ported():
    """``mesh=`` reaches the engine, which takes a lane mesh
    (tests/test_torch_sharded.py runs the rankers on one) and refuses
    anything else."""
    keys, block, _ = _near_duplicate_keys()
    with pytest.raises(TypeError, match="DeviceMesh"):
        TS.rank_blocks(keys, block=block, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        TS.BlockRanker(block=block, mesh=object(), device="cpu").extend(
            keys).rank()
