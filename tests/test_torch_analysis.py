"""quadlint for the port (``python -m repro_torch.analysis``) against the
reference's (``python -m repro.analysis``).

* On the same snippets the two engines give the same ``(rule, line)``
  findings for the rules they share in the same form: QL000 (the
  suppression contract), QL005 and QL006's numpy and stdlib cases.
* The torch forms, each with a clean twin: QL006 (torch's samplers
  without ``generator=``, in-place samplers, global seeding), QL007 (a
  raw ``torch.distributed`` collective reachable from a core/ ``while``
  round loop), QL008 (obs calls and ``print()`` in a CUDA-graph capture
  or a ``torch.compile``d function).
* QL001's mutation checks of tests/test_analysis.py, over the port's
  registries (monkeypatched live modules).
* The CLI's exit codes and output format are the reference's, and the
  port's own tree is clean.
"""
import collections
import dataclasses
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro_torch.core.solver as solver_mod
from repro.analysis import run_paths as ref_run_paths
from repro.analysis.engine import main as ref_main
from repro_torch.analysis import run_paths
from repro_torch.analysis.engine import main

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _write(tmp_path, rel_parts, code):
    p = tmp_path.joinpath(*rel_parts)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(code), encoding="utf-8")
    return p


def _lint(tmp_path, rel_parts, code):
    p = _write(tmp_path, rel_parts, code)
    return run_paths([str(p)], project_checks=False)


def _pairs(findings):
    return sorted((f.rule, f.line) for f in findings)


# ---------------------------------------------------------------------------
# the rules both engines share, on the same snippets

SHARED = {
    "ql000_no_reason": """
        import numpy as np
        x = np.random.rand(3)  # quadlint: disable=QL006
        """,
    "ql000_malformed": """
        X = 1  # quadlint: enable-everything
        """,
    "ql000_suppressed_with_reason": """
        import numpy as np
        # quadlint: disable=QL006 -- a fixture's throwaway draw
        x = np.random.rand(3)
        y = np.random.rand(3)  # quadlint: disable=QL006 -- likewise
        """,
    "ql000_not_suppressible": """
        X = 1  # quadlint: disable=QL000
        """,
    "ql005_shims": """
        from repro.core.judge import judge_threshold
        from repro.core import deprecation
        from ..core import bif_bounds
        import repro.core.precond
        """,
    "ql005_clean": """
        from repro.core import BIFSolver
        from ..core.solver import SolverConfig
        """,
    "ql006_numpy_stdlib": """
        import random
        from random import choice
        import numpy as np
        a = np.random.rand(3)
        b = np.random.default_rng()
        c = numpy.random.normal(size=3)
        """,
    "ql006_numpy_clean": """
        import numpy as np
        rng = np.random.default_rng(0)
        g = np.random.Generator(np.random.PCG64(1))
        a = rng.standard_normal(3)
        """,
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_rules_match_the_reference(name, tmp_path):
    p = _write(tmp_path, ("src", "pkg", "m.py"), SHARED[name])
    ref = [f for f in ref_run_paths([str(p)], project_checks=False)
           if f.rule in ("QL000", "QL005", "QL006")]
    got = run_paths([str(p)], project_checks=False)
    assert _pairs(got) == _pairs(ref)
    if not name.endswith("clean") and name != \
            "ql000_suppressed_with_reason":
        assert got


# ---------------------------------------------------------------------------
# QL006: torch's unkeyed randomness


def test_ql006_torch_samplers_and_global_seeds(tmp_path):
    findings = _lint(tmp_path, ("src", "pkg", "m.py"), """
        import torch
        a = torch.randn(3)
        b = torch.randint(0, 5, (3,))
        c = torch.rand_like(a)
        d = torch.empty(3).normal_()
        a.uniform_(0, 1)
        torch.manual_seed(0)
        torch.cuda.manual_seed_all(0)
        e = torch.multinomial(a.abs(), 2)
        """)
    assert _pairs(findings) == [("QL006", n) for n in range(3, 11)]


def test_ql006_torch_with_generators_is_fine(tmp_path):
    findings = _lint(tmp_path, ("src", "pkg", "m.py"), """
        import torch
        g = torch.Generator().manual_seed(0)
        a = torch.randn(3, generator=g)
        b = torch.randperm(5, generator=g)
        torch.empty(3).normal_(generator=g)
        a.uniform_(0, 1, generator=g)
        s = torch.initial_seed()
        """)
    assert findings == []


def test_ql006_tests_may_draw_as_they_like(tmp_path):
    findings = _lint(tmp_path, ("tests", "test_m.py"), """
        import torch
        torch.manual_seed(0)
        a = torch.randn(3)
        """)
    assert findings == []


# ---------------------------------------------------------------------------
# QL007: collective cadence in core/ round loops

LOOP = """
    import torch.distributed as dist

    def _gather(x, group):
        dist.all_gather_into_tensor(x, x, group=group)

    def drive(x, group, rounds):
        taken = 0
        while taken < rounds:
            {body}
            taken += 1
        dist.all_reduce(x, group=group)
        return x
    """


def test_ql007_raw_collective_in_a_core_round_loop(tmp_path):
    findings = _lint(tmp_path, ("src", "pkg", "core", "m.py"),
                     LOOP.format(body="dist.broadcast(x, 0, group=group)"))
    assert _pairs(findings) == [("QL007", 10)]


def test_ql007_transitive_through_a_module_helper(tmp_path):
    findings = _lint(tmp_path, ("src", "pkg", "core", "m.py"),
                     LOOP.format(body="_gather(x, group)"))
    assert _pairs(findings) == [("QL007", 5)]
    assert "line 9" in findings[0].message


def test_ql007_a_collective_taken_as_a_value(tmp_path):
    findings = _lint(tmp_path, ("src", "pkg", "core", "m.py"), """
        import torch.distributed as dist

        def _gather(out, x, group):
            fn = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
            fn(out, x, group=group)

        def drive(out, x, group):
            while True:
                _gather(out, x, group)
        """)
    assert _pairs(findings) == [("QL007", 6)]


def test_ql007_suppressed_cadence_helper_and_clean_twins(tmp_path):
    suppressed = _lint(tmp_path, ("src", "pkg", "core", "a.py"), """
        import torch.distributed as dist

        def _round_gather(x, group):
            # quadlint: disable=QL007 -- the cadence helper's one gather
            dist.all_gather_into_tensor(x, x, group=group)

        def drive(x, group):
            while True:
                _round_gather(x, group)
        """)
    assert suppressed == []
    outside = _lint(tmp_path, ("src", "pkg", "core", "b.py"),
                    LOOP.format(body="x = x + 1"))
    assert outside == []
    not_core = _lint(tmp_path, ("src", "pkg", "serve", "c.py"),
                     LOOP.format(body="dist.broadcast(x, 0, group=group)"))
    assert not_core == []


# ---------------------------------------------------------------------------
# QL008: host-side telemetry in captured scopes


def test_ql008_print_and_metrics_in_captured_scopes(tmp_path):
    findings = _lint(tmp_path, ("src", "pkg", "m.py"), """
        import torch
        from ..obs import metrics
        from ..obs.spans import span

        def _helper(x):
            metrics.counter("steps").inc()
            return x

        @torch.compile
        def compiled(x):
            print(x)
            return _helper(x)

        def fn(x):
            span("decode")
            return x

        graphed = torch.cuda.make_graphed_callables(fn, (torch.zeros(1),))

        def capture(g, x):
            with torch.cuda.graph(g):
                print("capturing")
            g.capture_begin()
            metrics.gauge("g").set(1.0)
            g.capture_end()
            print("host side")
        """)
    assert _pairs(findings) == [("QL008", 7), ("QL008", 12),
                                ("QL008", 16), ("QL008", 23),
                                ("QL008", 25)]


def test_ql008_host_side_is_fine(tmp_path):
    findings = _lint(tmp_path, ("src", "pkg", "m.py"), """
        import torch
        from ..obs import metrics

        def step(x):
            print(x)
            metrics.counter("steps").inc()
            return x + 1

        fast = torch.compile(lambda x: x * 2)

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
            metrics.gauge("g").set(1.0)
            return y
        """)
    assert findings == []
    tests_only = _lint(tmp_path, ("tests", "test_m.py"), """
        import torch

        @torch.compile
        def f(x):
            print(x)
            return x
        """)
    assert tests_only == []


# ---------------------------------------------------------------------------
# QL001: state-threading mutation checks over the port's registries


def _ql001():
    findings = run_paths([str(PORT / "core" / "solver.py")])
    return [f for f in findings if f.rule == "QL001"]


def test_ql001_port_is_clean():
    assert _ql001() == []


def test_ql001_unthreaded_quadstate_field_is_caught(monkeypatch):
    mutant = collections.namedtuple(
        "QuadState", solver_mod.QuadState._fields + ("block_basis",))
    monkeypatch.setattr(solver_mod, "QuadState", mutant)
    msgs = [f.message for f in _ql001()]
    assert any("block_basis" in m and "not claimed" in m for m in msgs)
    assert any("omits field 'block_basis'" in m for m in msgs)


def test_ql001_dropped_registry_entry_is_caught(monkeypatch):
    monkeypatch.setattr(solver_mod, "QUADSTATE_PER_LANE", ("st", "basis"))
    assert any("'coeffs'" in f.message and "not claimed" in f.message
               for f in _ql001())


def test_ql001_coeffhistory_mutations_are_caught(monkeypatch):
    import repro_torch.core.matfun as matfun_mod

    monkeypatch.setattr(matfun_mod, "COEFF_REPLACE_EXCLUDED", ())
    assert any("update_coeffs" in f.message and "'fnidx'" in f.message
               for f in _ql001())

    # a new field the writer never writes, and one the freeze walkers
    # would skip (not an init field: the port's analog of a field missing
    # from the reference's register_dataclass)
    names = [f.name for f in dataclasses.fields(matfun_mod.CoeffHistory)]
    mutant = dataclasses.make_dataclass(
        "CoeffHistory", names + ["block_buf",
                                 ("cache", object,
                                  dataclasses.field(init=False,
                                                    default=None))],
        frozen=True)
    monkeypatch.setattr(matfun_mod, "CoeffHistory", mutant)
    msgs = [f.message for f in _ql001()]
    assert any("block_buf" in m and "update_coeffs" in m for m in msgs)
    assert any("'cache'" in m and "not an init field" in m for m in msgs)


def test_ql001_excluded_field_registry_is_live(monkeypatch):
    import repro_torch.core.sharded as sharded_mod

    monkeypatch.setattr(sharded_mod, "SHARDED_STATE_EXCLUDED", ())
    assert any("_drive_sharded" in f.message and "'basis'" in f.message
               for f in _ql001())


def test_ql001_engine_admission_registry_is_live(monkeypatch):
    import repro_torch.serve.engine as engine_mod

    monkeypatch.setattr(engine_mod, "ENGINE_ADMIT_EXCLUDED", ())
    assert any("_pool_admit_run" in f.message and "'basis'" in f.message
               for f in _ql001())


def test_ql001_chainfactor_mutations_are_caught(monkeypatch):
    import repro_torch.core.update as update_mod

    monkeypatch.setattr(update_mod, "FACTOR_REPLACE_EXCLUDED", ())
    assert any("downdate" in f.message and "'n'" in f.message
               for f in _ql001())
    mutant = dataclasses.make_dataclass(
        "ChainFactor", [f.name for f in
                        dataclasses.fields(update_mod.ChainFactor)]
        + ["rank_cache"])
    monkeypatch.setattr(update_mod, "ChainFactor", mutant)
    msgs = [f.message for f in _ql001()]
    assert any("rank_cache" in m and "extend" in m for m in msgs)
    assert any("rank_cache" in m and "downdate" in m for m in msgs)


def test_ql001_blockstate_mutations_are_caught(monkeypatch):
    import repro_torch.core.block as block_mod

    mutant = dataclasses.make_dataclass(
        "BlockState", [f.name for f in
                       dataclasses.fields(block_mod.BlockState)]
        + ["reorth_buf"])
    monkeypatch.setattr(block_mod, "BlockState", mutant)
    assert any("reorth_buf" in f.message and "block_step" in f.message
               for f in _ql001())
    monkeypatch.undo()
    monkeypatch.setattr(block_mod, "BLOCK_REPLACE_EXCLUDED", ())
    msgs = [f.message for f in _ql001()]
    assert any("block_step" in m and "'r0'" in m for m in msgs)
    assert any("block_step" in m and "'fnidx'" in m for m in msgs)


def test_ql001_round_body_delegation_credit():
    """A handler inherits ``_round_body``'s freezes only if it reaches the
    round driver, directly or through the solver's helpers (the port's
    ``step_n`` -> ``_loop_parts`` -> ``_round_body``)."""
    import ast as _ast

    from repro_torch.analysis.contracts import _round_body_frozen

    tree = _ast.parse(textwrap.dedent("""
        def _round_body(op, stepfn):
            def substep(carry):
                st = tree_freeze(st1, st, frozen)
                coeffs = tree_freeze(coeffs1, coeffs, frozen)
                return carry
            return substep

        def _loop_parts(self, state):
            return self._round_body(op, stepfn)

        def delegating(self, state):
            return self._loop_parts(state)

        def freeloading(self, state):
            return state
    """))
    defs = {n.name: n for n in tree.body}
    assert {"st", "coeffs"} <= _round_body_frozen(defs["delegating"], tree)
    assert _round_body_frozen(defs["freeloading"], tree) == set()


# ---------------------------------------------------------------------------
# CLI + the port's own cleanliness


def test_cli_exit_codes_and_output_format_match_reference(tmp_path,
                                                          capsys):
    bad = _write(tmp_path, ("src", "pkg", "m.py"), "import random\n")
    good = _write(tmp_path, ("src", "pkg", "ok.py"), "X = 1\n")
    outs = []
    for fn in (main, ref_main):
        assert fn([str(bad)]) == 1
        out = capsys.readouterr().out
        assert re.search(r"^.+:1 QL006 ", out, re.M)
        assert "1 finding(s)" in out
        assert fn([str(good)]) == 0
        assert capsys.readouterr().out == ""
        outs.append(out.splitlines()[-1])
    assert outs[0] == outs[1]


def test_port_tree_is_clean_and_the_module_runs():
    findings = run_paths([str(PORT)])
    assert findings == [], "\n".join(f.render() for f in findings)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(PORT)],
        capture_output=True, text=True, env=env, cwd=str(REPO),
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""
