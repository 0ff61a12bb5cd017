"""K4's row list (``spmv_bell.bell_row_list``) and its route rule, on the
CPU: the list's plain product against ``bell_matvec_ref``, which tables
and vectors take the ``bell_rows`` route, and the per-table cache that a
table edited in place or a new table at a freed table's address rebuilds.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import graph_laplacian  # noqa: E402
from repro_torch.kernels import lanczos_step as tls  # noqa: E402
from repro_torch.kernels import spmv_bell as tsb  # noqa: E402


def _table(a, bs, dtype):
    d, c, _ = tsb.dense_to_bell(a, bs=bs, dtype=np.float64)
    return torch.as_tensor(d, dtype=dtype), torch.as_tensor(c)


def _padded(seed):
    """Blocks of 8 on the diagonal and one pair coupling block rows 0 and
    7: K = 2, so rows 1-6 hold a padding block (column 0, zero data);
    scattered entries in each block."""
    rng = np.random.default_rng(seed)
    n, bs = 64, 8
    a = np.zeros((n, n))
    for r, c in [(r, r) for r in range(n // bs)] + [(0, 7)]:
        blk = rng.standard_normal((bs, bs)) * (rng.random((bs, bs)) < 0.3)
        a[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = blk
    return a + a.T + 10.0 * np.eye(n), bs


def _ragged(seed):
    """A rewired ring of 300 nodes in blocks of 128: N is no multiple of
    bs, so the table's last block row ends in zero rows."""
    return graph_laplacian(300, mean_degree=6, rewire=0.1, seed=seed), 128


def _zero_row(seed):
    """A ring lattice with node 5's row and column zeroed."""
    a = graph_laplacian(96, mean_degree=4, rewire=0.0, seed=seed)
    a[5, :] = 0.0
    a[:, 5] = 0.0
    return a, 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", [_padded, _ragged, _zero_row],
                         ids=["padding_blocks", "ragged_n", "zero_row"])
def test_row_list_matches_bell_matvec_ref(case, dtype):
    """The row list holds every stored non-zero once, in the table's
    dtype, columns ascending within a row; its product equals the block
    product (both in f64) to the last bits."""
    a, bs = case(3)
    data, cols = _table(a, bs, dtype)
    if case is _padded:
        assert bool((data.abs().sum((-1, -2)) == 0).any())
    rows = tsb.bell_row_list(data, cols)
    n = data.shape[0] * bs
    assert rows.row_ptr.dtype == torch.int32 and rows.col.dtype == torch.int32
    assert rows.row_ptr.shape == (n + 1,) and int(rows.row_ptr[0]) == 0
    assert rows.val.dtype == dtype
    assert rows.col.numel() == int(torch.count_nonzero(data))
    assert torch.all(rows.val != 0)
    counts = rows.row_ptr[1:] - rows.row_ptr[:-1]
    assert torch.all(counts >= 0)
    stored = torch.as_tensor(a, dtype=dtype)
    assert torch.equal(counts[:a.shape[0]].long(),
                       torch.count_nonzero(stored, dim=1))
    assert int(counts[a.shape[0]:].sum()) == 0
    for i in range(n):
        lo, hi = int(rows.row_ptr[i]), int(rows.row_ptr[i + 1])
        assert torch.all(rows.col[lo + 1:hi] > rows.col[lo:hi - 1])
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((3, n)))
    want = tsb.bell_matvec_ref(data, cols, x)
    got = tsb.row_list_matvec(rows, x)
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13)


def _sparse_filled():
    """A rewired ring of 2048 nodes, blocks of 128: the scattered edges
    spread each block row over most block columns, hundreds of stored
    values per non-zero."""
    a = graph_laplacian(2048, mean_degree=6, rewire=0.05, seed=1)
    return _table(a, 128, torch.float32)


def _dense_filled():
    """The ring lattice without rewiring, blocks of 128: three blocks a
    block row, about 23 stored values per non-zero."""
    a = graph_laplacian(1024, mean_degree=16, rewire=0.0, seed=1)
    return _table(a, 128, torch.float32)


def _per_lane():
    data, cols = _sparse_filled()
    return torch.stack([data] * 2), torch.stack([cols] * 2)


# the shared memory a CTA may opt into on the H100 (227 KiB), as
# ``torch.cuda.get_device_properties`` gives it there
H100_SMEM_OPTIN = 227 * 1024


def _too_wide():
    """One diagonal block a block row, 128 stored values per non-zero, but
    two lanes of 116 * 128 rows in f64 are past the shared memory a CTA may
    hold on the H100 (one lane alone would fit)."""
    r, bs = 116, 128
    data = torch.eye(bs).expand(r, 1, bs, bs).contiguous()
    return data, torch.arange(r, dtype=torch.int32).reshape(r, 1)


@pytest.mark.parametrize("case,vec_dtype,want", [
    (_sparse_filled, torch.float64, "bell_rows"),
    (_sparse_filled, torch.float32, "bell_fma_f32"),
    (_per_lane, torch.float64, "bell_lane"),
    (_dense_filled, torch.float64, "bell_dmma"),
    (_too_wide, torch.float64, "bell_dmma")],
    ids=["sparse_filled", "f32_vectors", "per_lane", "dense_filled",
         "too_wide"])
def test_route_rule(case, vec_dtype, want):
    """Only a shared table with f64 vectors, a fill above ROWS_FILL and a
    pair of lanes that fits in shared memory takes the rows route, and is
    handed its row list; the row list is built only for such a table, and
    only the fill is kept for a dense-filled one."""
    data, cols = case()
    which, rows = tls.bell_route(data, cols, vec_dtype, H100_SMEM_OPTIN)
    assert which == want
    assert (rows is not None) == (want == "bell_rows")
    entry = tsb._TABLE_ROWS.get(id(data))
    if want in ("bell_lane", "bell_fma_f32", "bell_dmma") \
            and case is not _dense_filled:
        assert entry is None          # nothing read from the table
        return
    fill = data.numel() / int(torch.count_nonzero(data))
    assert entry[3].fill == pytest.approx(fill)
    assert (fill > tsb.ROWS_FILL) == (want == "bell_rows")
    assert (entry[3].rows is not None) == (want == "bell_rows")
    if rows is not None:
        assert rows is entry[3].rows


def _ring():
    """A rewired ring of 1024 nodes in blocks of 128 (about 160 stored
    values per non-zero, past ROWS_FILL)."""
    return graph_laplacian(1024, mean_degree=6, rewire=0.1, seed=2)


@pytest.mark.parametrize("change", ["edited_in_place",
                                    "new_table_at_a_freed_address"])
def test_row_list_cache_rebuilds(change):
    """A second call on the same table reads the cached list; a table
    edited in place, or a new table at a freed table's address (the
    interpreter reuses it, or a stale entry is planted under the new
    table's id), gets a list built from what it holds now."""
    a = _ring()
    data, cols = _table(a, 128, torch.float32)
    first = tsb.table_rows(data, cols)
    assert first.rows is not None
    assert tsb.table_rows(data, cols) is first
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (2, data.shape[0] * 128)))
    if change == "edited_in_place":
        data.mul_(2.0)
        again = tsb.table_rows(data, cols)
        assert again is not first
        torch.testing.assert_close(tsb.row_list_matvec(again.rows, x),
                                   tsb.bell_matvec_ref(data, cols, x))
        return
    other = tsb.dense_to_bell(3.0 * a, bs=128, dtype=np.float32)[0]
    old = id(data)
    del data
    assert old not in tsb._TABLE_ROWS      # dropped with its table
    for _ in range(64):
        data = torch.as_tensor(other)
        if id(data) == old:
            break
    # the freed table's entry, as if still under this address
    assert id(data) not in tsb._TABLE_ROWS
    tsb._TABLE_ROWS[id(data)] = (lambda: None, lambda: cols,
                                 (0, cols._version), first)
    again = tsb.table_rows(data, cols)
    assert again is not first
    torch.testing.assert_close(tsb.row_list_matvec(again.rows, x),
                               tsb.bell_matvec_ref(data, cols, x))
