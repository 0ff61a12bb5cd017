"""The configurations' generators on the CPU at small sizes: the graph has
the edge count and shape its configuration states and does not change
with the run's seed; the blocked-ELL table holds the stored operator
exactly; a split measure finds its one reader."""
import json
from pathlib import Path

import pytest
import torch

from quadbench import harness, problems, reference

HERE = Path(__file__).resolve().parent
GRAPH = dict(json.loads((HERE / "configs" / "grqc-laplacian-5242.json")
                        .read_text()), n=640, edges=1770)


def test_graph_has_its_edges_and_no_loops():
    a = problems.graph_adjacency(GRAPH, torch.device("cpu"))
    assert torch.equal(a, a.T)
    assert float(a.diagonal().abs().sum()) == 0.0
    assert set(a.unique().tolist()) == {0.0, 1.0}
    # a moved edge may merge with one already there, and no other is lost
    edges = int(a.sum()) // 2
    assert GRAPH["edges"] - 5 <= edges <= GRAPH["edges"]
    assert int(a.sum(1).min()) >= 1


def test_graph_is_the_configurations_not_the_runs():
    dev = torch.device("cpu")
    a = problems.graph_adjacency(GRAPH, dev)
    assert torch.equal(a, problems.graph_adjacency(GRAPH, dev))
    other = problems.graph_adjacency(dict(GRAPH, graph_seed=1), dev)
    assert not torch.equal(a, other)
    unwired = problems.graph_adjacency(dict(GRAPH, rewire=0.0), dev)
    assert int(unwired.sum()) // 2 == GRAPH["edges"]
    # without rewiring every edge joins nodes at most 3 apart on the ring
    i, j = torch.nonzero(unwired, as_tuple=True)
    hop = torch.minimum((i - j) % 640, (j - i) % 640)
    assert int(hop.max()) == 3


def test_bell_table_holds_the_stored_operator():
    dev = torch.device("cpu")
    cfg = dict(GRAPH, n=300, edges=830)
    p = problems.build(cfg, dev)
    data, cols = p["data"], p["cols"].long()
    bs = cfg["block_size"]
    r = data.shape[0]
    dense = torch.zeros((r * bs, r * bs), dtype=data.dtype)
    for row in range(r):
        for k in range(data.shape[1]):
            c = int(cols[row, k])
            dense[row * bs:(row + 1) * bs, c * bs:(c + 1) * bs] += data[row, k]
    want = reference.laplacian_operator(p["adjacency"], cfg, torch.float32)
    assert torch.equal(dense[:300, :300], want)
    assert float(dense[300:].abs().sum() + dense[:, 300:].abs().sum()) == 0
    assert p["lam"][0] == pytest.approx(cfg["ridge"], rel=1e-4)


@pytest.mark.parametrize("name,file", [
    ("idle_pct.dense", "idle_pct.py"), ("mfu.sparse", "mfu.py"),
    ("bifs_per_s", "bifs_per_s.py"),
    ("fused_step_bell_roofline", "fused_step_bell_roofline.py")])
def test_a_split_measure_finds_its_reader(name, file):
    assert harness.reader_path(name).name == file
