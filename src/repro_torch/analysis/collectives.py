"""QL007: collective cadence in the port's round loops (counterpart of
``repro.analysis.collectives``).

The reference's rule (DESIGN.md Sec. 11): ``core/`` loop bodies issue no
raw collectives; round-boundary communication goes through the cadence
helper (``core.sharded._round_gather``): one packed all-gather a
``decide_every`` round carrying the brackets AND the folded continue
flag, so the hot loop never pays a per-iteration collective pair. In the
port a round loop is a Python ``while`` statement (the reference's
``lax.while_loop``), and a collective is any ``torch.distributed``
collective, called or taken as a value (``fn = dist.all_gather_...``),
and the functional collectives. The walk is transitive through the
module's function defs, and each finding anchors at the collective's own
line: the cadence helper's gather carries the one documented
suppression.

QL004 (collective pairing under ``lax.while_loop`` in ``shard_map``) has
no counterpart: the port's rounds are host loops whose continue flag is
the gathered one, so every rank takes the same trips by construction.
"""
from __future__ import annotations

import ast
from typing import Iterable

from .engine import FileContext, Finding
from .rules_ast import dotted, last_component

_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_single", "all_gather_object", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
    "broadcast", "broadcast_object_list", "reduce", "gather", "scatter",
    "send", "recv", "isend", "irecv", "barrier", "all_gather_tensor",
    "all_reduce_coalesced", "permute_tensor"}
# module aliases a collective is reached through
_PREFIXES = ("dist", "distributed", "funcol", "_functional_collectives",
             "c10d")


def _collective(node: ast.AST) -> str | None:
    """The collective a ``dist.<name>`` reference names, or None."""
    d = dotted(node)
    if d is None or "." not in d:
        return None
    base, name = d.rsplit(".", 1)
    if name in _COLLECTIVES and base.rsplit(".", 1)[-1] in _PREFIXES:
        return name
    return None


def _module_defs(tree: ast.Module) -> dict:
    """name -> def for every named function in the module (first def
    wins); the walk follows calls to these."""
    defs: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    return defs


def _reachable(stmts, defs: dict) -> list:
    """(name, lineno) of every collective reference reachable from
    ``stmts`` through calls to the module's functions."""
    found: list = []
    seen: set = set()
    stack = [list(stmts)]
    while stack:
        for top in stack.pop():
            for node in ast.walk(top):
                if isinstance(node, ast.Attribute):
                    name = _collective(node)
                    if name is not None:
                        found.append((name, node.lineno))
                elif isinstance(node, ast.Call):
                    callee = last_component(node.func)
                    fn = defs.get(callee)
                    if fn is not None and id(fn) not in seen:
                        seen.add(id(fn))
                        stack.append(fn.body)
    return found


def check_collective_cadence(ctx: FileContext) -> Iterable[Finding]:
    """QL007: no raw collective reachable from a ``while`` loop in
    ``core/`` -- the round loop's only collective is the cadence
    helper's single gather a round."""
    if not (ctx.in_src and "core" in ctx.parts):
        return []
    defs = _module_defs(ctx.tree)
    findings: list = []
    seen: set = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.While):
            continue
        for name, lineno in _reachable([node.test] + node.body, defs):
            if (lineno, name) in seen:
                continue
            seen.add((lineno, name))
            findings.append(Finding(
                ctx.rel, lineno, "QL007",
                f"raw {name} reachable from a core/ round loop (the "
                f"`while` at line {node.lineno}) -- route round-boundary "
                f"communication through the cadence helper so each "
                f"decide_every round pays one packed collective "
                f"(DESIGN.md Sec. 11)"))
    return findings
