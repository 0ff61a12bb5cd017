"""BENCHMARK.json against the benchmark's contract: names, units, keys and
limits, the files each entry names, and the readers each metric needs."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "quadbench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(section):
    items = MAN[section]
    assert items
    names = [it["name"] for it in items]
    assert len(set(names)) == len(names)
    for it in items:
        extra = {"workloads"} if section in ("end_to_end",
                                             "per_layer") else set()
        assert KEYS[section] <= set(it) <= KEYS[section] | extra, it
        assert NAME.match(it["name"]), it["name"]
        for key in ("why", "source", "layer"):
            if key in it:
                assert line(it[key]), (it["name"], key)
        if "unit" in it:
            assert UNIT.match(it["unit"]), it["unit"]
        if "better" in it:
            assert it["better"] in ("lower", "higher")


def test_metric_names_unique_across_sections():
    names = [m["name"] for s in ("end_to_end", "per_layer")
             for m in MAN[s]]
    assert len(set(names)) == len(names)


def test_end_to_end_bounds_and_sources():
    by = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in by and "workloads" not in by["setup_s"]
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    cells = {w["name"] for w in MAN["workloads"]}
    for w in cells:
        reported = [m for m in MAN["end_to_end"]
                    if w in m.get("workloads", [w])]
        assert len(reported) >= 2, w   # setup_s and at least one other


def test_configs_and_cells():
    cells = MAN["workloads"]
    used = {w["config"] for w in cells}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert "assumed" in cfg
    for w in cells:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (HERE / "workloads" / f"{w['traffic']}.json").exists()


def test_per_layer_metrics_are_read_where_their_moves_is_reported():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert m["source"] in SOURCES
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w]), (m, w)
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in cells:
        assert any(w in m["workloads"] for m in MAN["per_layer"]), w


@pytest.mark.parametrize("name", sorted(
    m["name"] for s in ("end_to_end", "per_layer") for m in MAN[s]))
def test_every_metric_has_its_reader(name):
    from quadbench import harness
    src = harness.reader_path(name).read_text()
    assert "def read(ctx)" in src


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_traffic_limits(cell):
    w = next(x for x in MAN["workloads"] if x["name"] == cell)
    mix = json.loads((HERE / "workloads" / f"{w['traffic']}.json")
                     .read_text())
    limits = mix["limits"]
    assert all(v >= 0 for v in limits.values())
    if "gap" in limits:
        # the configuration states the bracket's width: that is the limit
        assert limits["gap"] == mix["solver"]["rtol"]
    assert mix["profile_calls"] >= 1
