"""The configurations' inputs, made on the device from their own seeds.

A frozen copy of the repository's ``rbf_kernel`` (its point cloud and
truncated Gaussian kernel) and a ring lattice rewired to a co-authorship
graph's size, degree and clustering, written for the device, and the
operator the program is handed: a dense matrix, or the blocked-ELL
table. A configuration file names its ``kind``; ``build`` dispatches on
it. Nothing here imports the program.
"""
from __future__ import annotations

import hashlib
import time

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def generator(dev, seed: int, *tags) -> torch.Generator:
    """A generator on ``dev`` seeded from the run's seed and ``tags``: the
    same (seed, tags) gives the same draws, and streams of other tags are
    independent."""
    h = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode()).digest()
    g = torch.Generator(device=dev)
    g.manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return g


# -- the dense RBF kernel (Abalone's regime) --------------------------------

def rbf_box(cfg) -> float:
    """Side of the point cloud's box, scaled so that the cutoff keeps only
    local neighbourhoods (``rbf_kernel``'s rule)."""
    return cfg["n"] ** (1.0 / cfg["dim"]) * cfg["sigma"] * 1.2


def rbf_points(cfg, count: int, gen, dev) -> torch.Tensor:
    """``count`` points drawn uniformly from the box, f64."""
    return torch.rand((count, cfg["dim"]), generator=gen, device=dev,
                      dtype=torch.float64) * rbf_box(cfg)


def rbf_cross(x, y, cfg) -> torch.Tensor:
    """The truncated Gaussian kernel k(x, y): exp(-|x - y|^2 / 2 sigma^2),
    zero beyond ``cutoff * sigma``; (len(x), len(y))."""
    d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    k = torch.exp(-d2 / (2.0 * cfg["sigma"] ** 2))
    return k.masked_fill(d2.sqrt() > cfg["cutoff"] * cfg["sigma"], 0.0)


def rbf_matrix(x, cfg) -> torch.Tensor:
    """K(X, X) with a unit diagonal, plus ``ridge * I``."""
    k = rbf_cross(x, x, cfg)
    k.diagonal().fill_(1.0 + cfg["ridge"])
    return k


# -- the small-world co-authorship Laplacian (GR/HEP's regime) -------------

def graph_adjacency(cfg, dev) -> torch.Tensor:
    """The configuration's graph as a dense f64 adjacency: a ring lattice of
    ``n`` nodes with exactly ``edges`` edges (each node joined to its
    ``ceil(edges / n) - 1`` successors, and a random subset of the nodes
    to one successor further), then each edge's far end moved to another
    node drawn uniformly with probability ``rewire`` (a Watts-Strogatz
    step; an edge moved onto one already there merges with it). The
    draws come from the configuration's ``graph_seed``, so every run
    serves the same graph."""
    n, m = cfg["n"], cfg["edges"]
    g = generator(dev, cfg["graph_seed"], "graph")
    half = -(-m // n)
    idx = torch.arange(n, device=dev)
    far = torch.randperm(n, generator=g, device=dev)[:m - (half - 1) * n]
    src = torch.cat([idx] * (half - 1) + [far])
    hop = torch.cat([torch.full((n,), j, device=dev)
                     for j in range(1, half)]
                    + [torch.full(far.shape, half, device=dev)])
    dst = (src + hop) % n
    moved = torch.rand(src.shape, generator=g, device=dev,
                       dtype=torch.float64) < cfg["rewire"]
    other = torch.randint(0, n - 1, src.shape, generator=g, device=dev)
    other = other + (other >= src).to(other.dtype)   # never src itself
    dst = torch.where(moved, other, dst)
    a = torch.zeros((n, n), dtype=torch.float64, device=dev)
    a[src, dst] = 1.0
    return torch.maximum(a, a.T)


def stored_laplacian(adj, cfg) -> torch.Tensor:
    """``diag(degree) - adjacency + ridge * I`` rounded to the blocks' type
    (f32), as the blocked-ELL table holds it."""
    lap = torch.diag(adj.sum(1) + cfg["ridge"]) - adj
    return lap.to(DTYPES[cfg["block_dtype"]])


def bell_table(a, bs: int):
    """The blocked-ELL form of the square matrix ``a``: ``data`` (R, K, bs,
    bs) with the non-zero blocks of each block row in column order and
    zero blocks as padding (column 0), ``cols`` (R, K) int32."""
    n = a.shape[0]
    r = -(-n // bs)
    pad = r * bs - n
    ap = torch.nn.functional.pad(a, (0, pad, 0, pad)) if pad else a
    blocks = ap.reshape(r, bs, r, bs).permute(0, 2, 1, 3)
    nz = blocks.abs().sum((-1, -2)) > 0                       # (R, R)
    k = int(nz.sum(1).max())
    # non-zero block columns first, in column order; then the padding
    order = torch.argsort((~nz).to(torch.int64) * r
                          + torch.arange(r, device=a.device), dim=1)
    cols = order[:, :k]
    real = torch.gather(nz, 1, cols)
    data = blocks[torch.arange(r, device=a.device)[:, None], cols]
    data = data * real[..., None, None]
    cols = torch.where(real, cols, torch.zeros_like(cols))
    return data.contiguous(), cols.to(torch.int32).contiguous()


# -- the problems -----------------------------------------------------------

def build(cfg, dev) -> dict:
    """The configuration's inputs on ``dev``: the matrix or table the
    program is handed, what the reference needs to rebuild the operator,
    and the spectral interval (the extreme eigenvalues widened by the
    configuration's margins), with the seconds its eigenvalues took."""
    lo_m, hi_m = cfg["interval_margin"]
    if cfg["kind"] == "rbf":
        # the data set is the configuration's: its points come from the
        # configuration's own seed, not the run's (the run's seed draws
        # the traffic)
        pts = rbf_points(cfg, cfg["n"],
                         generator(dev, cfg["points_seed"], "points"), dev)
        a = rbf_matrix(pts, cfg)
        t = time.perf_counter()
        w = torch.linalg.eigvalsh(a)
        lam = (float(w[0]), float(w[-1]))
        interval_s = time.perf_counter() - t
        out = dict(kind="rbf", points=pts, a=a,
                   nnz=int(torch.count_nonzero(a)))
    elif cfg["kind"] == "graph_laplacian":
        adj = graph_adjacency(cfg, dev)
        a32 = stored_laplacian(adj, cfg)
        data, cols = bell_table(a32, cfg["block_size"])
        diag = torch.diagonal(a32).to(DTYPES[cfg["diag_dtype"]])
        t = time.perf_counter()
        w = torch.linalg.eigvalsh(a32.to(torch.float64))
        lam = (float(w[0]), float(w[-1]))
        interval_s = time.perf_counter() - t
        out = dict(kind="graph_laplacian", adjacency=adj, data=data,
                   cols=cols, diag=diag, nnz=int(torch.count_nonzero(a32)))
        del a32
    else:
        raise ValueError(f"unknown configuration kind {cfg['kind']!r}")
    if not lam[0] > 0:
        raise ValueError(f"{cfg['name']}: the operator is not SPD "
                         f"(lambda_min = {lam[0]})")
    out.update(n=cfg["n"], lam=lam, lmn=lo_m * lam[0], lmx=hi_m * lam[1],
               interval_s=interval_s)
    return out
