"""QL001: state-threading completeness for the port's state containers
(counterpart of ``repro.analysis.contracts``).

The port carries the reference's state containers -- ``QuadState``
(core/solver.py), ``GQLState`` (core/gql.py), ``CoeffHistory``
(core/matfun.py), ``BlockState`` (core/block.py) and ``ChainFactor``
(core/update.py) -- through the same handler layers: the single-device
freeze loops (``step_n`` / ``resume``, through ``_round_body``), the
sharded driver (``_drive_sharded``), the serving pool
(``_pool_admit_run``) and the per-step writers (``update_coeffs``,
``block_step``, ``extend`` / ``downdate``). A field added to a container
but not threaded through every handler is a finding:

  * the LIVE field sets come from importing the port's modules
    (``QuadState._fields``, ``dataclasses.fields``), so a field added to
    the class is seen the moment it exists;
  * each QuadState field must be claimed by exactly one of the registries
    next to the class (``QUADSTATE_PER_LANE`` / ``QUADSTATE_CARRIED`` /
    ``QUADSTATE_PREPARED``);
  * the handler sites are checked by AST against those registries:
    ``_replace`` / constructor keyword coverage, ``tree_freeze``
    arguments, and the documented per-handler exclusions
    (``SHARDED_STATE_EXCLUDED``, ``ENGINE_ADMIT_EXCLUDED``,
    ``COEFF_REPLACE_EXCLUDED``, ``BLOCK_REPLACE_EXCLUDED``,
    ``FACTOR_REPLACE_EXCLUDED``).

Where the reference checks ``jax.tree_util.register_dataclass``, the port
has no registry: ``loop_utils.tree_freeze`` / ``tree_map`` walk a
dataclass's ``init`` fields. So the dataclass containers must be
dataclasses whose every field is an ``init`` field, or a freeze would
silently drop it.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import sys
from pathlib import Path
from typing import Iterable, Optional

from .engine import FileContext, Finding

RULE = "QL001"

# repo-relative suffixes of the contract's handler files
_PKG = "repro_torch"
_ROLE_SUFFIX = {
    "solver": ("src", _PKG, "core", "solver.py"),
    "gql": ("src", _PKG, "core", "gql.py"),
    "matfun": ("src", _PKG, "core", "matfun.py"),
    "sharded": ("src", _PKG, "core", "sharded.py"),
    "engine": ("src", _PKG, "serve", "engine.py"),
    "update": ("src", _PKG, "core", "update.py"),
    "block": ("src", _PKG, "core", "block.py"),
}
_ROLE_MODULE = {
    "solver": f"{_PKG}.core.solver",
    "gql": f"{_PKG}.core.gql",
    "matfun": f"{_PKG}.core.matfun",
    "sharded": f"{_PKG}.core.sharded",
    "engine": f"{_PKG}.serve.engine",
    "update": f"{_PKG}.core.update",
    "block": f"{_PKG}.core.block",
}


def _role_paths(contexts: Iterable[FileContext]) -> Optional[dict]:
    """Locate the five handler files. Activation is keyed on solver.py
    being in the scan set; the siblings are derived from its location
    (the contract is cross-file — scanning src/ always covers all)."""
    anchor = None
    for ctx in contexts:
        if ctx.parts[-len(_ROLE_SUFFIX["solver"]):] \
                == _ROLE_SUFFIX["solver"]:
            anchor = ctx
            break
    if anchor is None:
        return None
    root = Path(*anchor.parts[:-len(_ROLE_SUFFIX["solver"])])
    by_path = {c.path: c for c in contexts}
    roles: dict = {}
    for role, suffix in _ROLE_SUFFIX.items():
        p = root.joinpath(*suffix)
        roles[role] = by_path.get(p) or p
    return roles


def _parse(roles: dict, role: str) -> tuple:
    """(rel display path, ast.Module) for a role file — from the scanned
    context when available, from disk otherwise."""
    entry = roles[role]
    if isinstance(entry, FileContext):
        return entry.rel, entry.tree
    source = entry.read_text(encoding="utf-8")
    return str(entry), ast.parse(source, filename=str(entry))


def _import_role(roles: dict, role: str):
    """Import the live module (registry + field sets). The already-
    imported module is reused, so tests can monkeypatch mutations."""
    mod_name = _ROLE_MODULE[role]
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    entry = roles[role]
    path = entry.path if isinstance(entry, FileContext) else entry
    src_dir = str(Path(*path.parts[:path.parts.index(_PKG)]))
    if src_dir not in sys.path:
        sys.path.insert(0, src_dir)
    return importlib.import_module(mod_name)


# ---------------------------------------------------------------------------
# AST helpers


def _find_def(tree: ast.Module, name: str):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _class_line(tree: ast.Module, name: str) -> int:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node.lineno
    return 1


def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _replace_kwargs(fn) -> set:
    """Keyword names across every ``<expr>._replace(...)`` call in fn."""
    out: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _call_name(node) == "_replace":
            out.update(kw.arg for kw in node.keywords if kw.arg)
    return out


def _frozen_names(fn) -> set:
    """Names a ``tree_freeze(new, old, flag)`` call site threads: the
    bare names / attribute tails of its first two arguments (so both
    ``tree_freeze(st1, st, ...)`` and ``tree_freeze(state.st, st, ...)``
    claim the field ``st``; the ``X1`` convention strips a trailing 1)."""
    out: set = set()
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and _call_name(node) == "tree_freeze"):
            continue
        for arg in node.args[:2]:
            name = None
            if isinstance(arg, ast.Name):
                name = arg.id
            elif isinstance(arg, ast.Attribute):
                name = arg.attr
            if name:
                out.add(name)
                if name.endswith("1"):
                    out.add(name[:-1])
    return out


def _round_body_frozen(fn, solver_tree) -> set:
    """The per-substep freeze lives in the shared round driver
    ``BIFSolver._round_body`` (so single-device and sharded drives cannot
    drift); a handler that delegates to it -- directly, or through the
    solver's helpers (``step_n`` -> ``_loop_parts`` -> ``_round_body``) --
    inherits its tree_freeze coverage. Only handlers that actually reach
    ``_round_body`` get the credit: a new handler that skips the round
    driver still has to freeze for itself."""
    defs = {n.name: n for n in ast.walk(solver_tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    seen: set = set()
    stack = [fn]
    while stack:
        cur = stack.pop()
        if id(cur) in seen:
            continue
        seen.add(id(cur))
        for node in ast.walk(cur):
            name = node.attr if isinstance(node, ast.Attribute) else \
                node.id if isinstance(node, ast.Name) else None
            if name == "_round_body":
                rb = defs.get("_round_body")
                return _frozen_names(rb) if rb is not None else set()
            if name in defs and defs[name] is not cur:
                stack.append(defs[name])
    return set()


def _ctor_calls(tree: ast.Module, class_name: str) -> list:
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and _call_name(node) == class_name]


def _tuple_literal(mod, attr: str) -> Optional[tuple]:
    val = getattr(mod, attr, None)
    if isinstance(val, (tuple, list)) \
            and all(isinstance(x, str) for x in val):
        return tuple(val)
    return None


def _walkable(cls, name: str, rel: str, line: int, what: str) -> list:
    """Findings where ``tree_freeze`` / ``tree_map`` would not walk a
    dataclass container whole: not a dataclass, or a field that is not an
    ``init`` field (the walkers rebuild through ``dataclasses.replace``
    over the init fields)."""
    if not dataclasses.is_dataclass(cls):
        return [Finding(rel, line, RULE,
                        f"{name} is not a dataclass (tree_freeze / "
                        f"tree_map would reject it and it would fall out "
                        f"of {what})")]
    return [Finding(rel, line, RULE,
                    f"{name} field '{f.name}' is not an init field — "
                    f"tree_freeze / tree_map would silently drop it")
            for f in dataclasses.fields(cls) if not f.init]


# ---------------------------------------------------------------------------
# the checks


def check_contracts(contexts: Iterable[FileContext]) -> list:
    contexts = list(contexts)
    roles = _role_paths(contexts)
    if roles is None:
        return []
    for role, entry in roles.items():
        if not isinstance(entry, FileContext) and not entry.exists():
            return [Finding(str(entry), 1, RULE,
                            f"contract handler file for role '{role}' "
                            f"is missing")]
    findings: list = []
    try:
        solver_mod = _import_role(roles, "solver")
        gql_mod = _import_role(roles, "gql")
        matfun_mod = _import_role(roles, "matfun")
        sharded_mod = _import_role(roles, "sharded")
        engine_mod = _import_role(roles, "engine")
    except Exception as e:  # pragma: no cover - import environment broken
        rel, _ = _parse(roles, "solver")
        return [Finding(rel, 1, RULE,
                        f"cannot import the runtime modules to read the "
                        f"live field sets: {e!r}")]

    solver_rel, solver_tree = _parse(roles, "solver")
    sharded_rel, sharded_tree = _parse(roles, "sharded")
    engine_rel, engine_tree = _parse(roles, "engine")
    gql_rel, gql_tree = _parse(roles, "gql")
    matfun_rel, matfun_tree = _parse(roles, "matfun")

    # ---- QuadState: registry partition --------------------------------
    qfields = tuple(solver_mod.QuadState._fields)
    qline = _class_line(solver_tree, "QuadState")
    buckets = {}
    for name in ("QUADSTATE_PER_LANE", "QUADSTATE_CARRIED",
                 "QUADSTATE_PREPARED"):
        bucket = _tuple_literal(solver_mod, name)
        if bucket is None:
            findings.append(Finding(
                solver_rel, qline, RULE,
                f"threading-contract registry `{name}` missing from "
                f"core/solver.py (tuple of field-name strings)"))
            bucket = ()
        buckets[name] = bucket
    claimed: list = [f for b in buckets.values() for f in b]
    for f in qfields:
        n = claimed.count(f)
        if n == 0:
            findings.append(Finding(
                solver_rel, qline, RULE,
                f"QuadState field '{f}' is not claimed by any threading-"
                f"contract registry (QUADSTATE_PER_LANE/_CARRIED/"
                f"_PREPARED) — decide how it threads before it ships"))
        elif n > 1:
            findings.append(Finding(
                solver_rel, qline, RULE,
                f"QuadState field '{f}' is claimed by {n} registries; "
                f"buckets must partition the fields"))
    for f in claimed:
        if f not in qfields:
            findings.append(Finding(
                solver_rel, qline, RULE,
                f"threading-contract registry names '{f}', which is not "
                f"a QuadState field"))

    per_lane = tuple(buckets["QUADSTATE_PER_LANE"])
    threaded = per_lane + tuple(buckets["QUADSTATE_CARRIED"])

    # ---- QuadState: ctor completeness ---------------------------------
    for rel, tree in ((solver_rel, solver_tree), (sharded_rel,
                      sharded_tree), (engine_rel, engine_tree)):
        for call in _ctor_calls(tree, "QuadState"):
            kwargs = {kw.arg for kw in call.keywords if kw.arg}
            for f in qfields:
                if f not in kwargs:
                    findings.append(Finding(
                        rel, call.lineno, RULE,
                        f"QuadState(...) omits field '{f}' — every "
                        f"construction site must thread all fields "
                        f"explicitly (keyword form)"))

    # ---- QuadState: freeze-loop handlers (step_n / resume) ------------
    for fn_name in ("step_n", "resume"):
        fn = _find_def(solver_tree, fn_name)
        if fn is None:
            findings.append(Finding(
                solver_rel, 1, RULE,
                f"BIFSolver.{fn_name} not found (the freeze-loop "
                f"handler the contract is checked against)"))
            continue
        replaced = _replace_kwargs(fn)
        frozen = _frozen_names(fn) | _round_body_frozen(fn, solver_tree)
        for f in threaded:
            if f not in replaced:
                findings.append(Finding(
                    solver_rel, fn.lineno, RULE,
                    f"BIFSolver.{fn_name} does not thread QuadState "
                    f"field '{f}' through its _replace"))
        for f in per_lane:
            if f not in frozen:
                findings.append(Finding(
                    solver_rel, fn.lineno, RULE,
                    f"BIFSolver.{fn_name} never tree_freeze-s per-lane "
                    f"QuadState field '{f}' (resolved lanes would keep "
                    f"stepping)"))

    # ---- QuadState: sharded driver ------------------------------------
    sharded_excluded = _tuple_literal(sharded_mod,
                                      "SHARDED_STATE_EXCLUDED") or ()
    if _tuple_literal(sharded_mod, "SHARDED_STATE_EXCLUDED") is None:
        findings.append(Finding(
            sharded_rel, 1, RULE,
            "`SHARDED_STATE_EXCLUDED` registry missing from "
            "core/sharded.py (fields the sharded driver rejects "
            "up front)"))
    drive = _find_def(sharded_tree, "_drive_sharded")
    if drive is None:
        findings.append(Finding(
            sharded_rel, 1, RULE,
            "_drive_sharded not found (the sharded threading handler)"))
    else:
        replaced = _replace_kwargs(drive)
        frozen = _frozen_names(drive) \
            | _round_body_frozen(drive, solver_tree)
        for f in threaded:
            if f not in replaced and f not in sharded_excluded:
                findings.append(Finding(
                    sharded_rel, drive.lineno, RULE,
                    f"_drive_sharded neither threads QuadState field "
                    f"'{f}' through _replace nor lists it in "
                    f"SHARDED_STATE_EXCLUDED"))
        for f in per_lane:
            if f not in frozen and f not in sharded_excluded:
                findings.append(Finding(
                    sharded_rel, drive.lineno, RULE,
                    f"_drive_sharded never tree_freeze-s per-lane "
                    f"field '{f}' (and it is not excluded)"))

    # ---- QuadState: serving pool admission / banking ------------------
    engine_excluded = _tuple_literal(engine_mod,
                                     "ENGINE_ADMIT_EXCLUDED") or ()
    if _tuple_literal(engine_mod, "ENGINE_ADMIT_EXCLUDED") is None:
        findings.append(Finding(
            engine_rel, 1, RULE,
            "`ENGINE_ADMIT_EXCLUDED` registry missing from "
            "serve/engine.py (per-lane fields the pool scheduler "
            "refuses via its lockstep fallback)"))
    admit = _find_def(engine_tree, "_pool_admit_run")
    if admit is None:
        findings.append(Finding(
            engine_rel, 1, RULE,
            "_pool_admit_run not found (the pool-admission handler)"))
    else:
        replaced = _replace_kwargs(admit)
        frozen = _frozen_names(admit)
        for f in per_lane:
            if f not in replaced and f not in engine_excluded:
                findings.append(Finding(
                    engine_rel, admit.lineno, RULE,
                    f"_pool_admit_run neither merges per-lane QuadState "
                    f"field '{f}' through _replace nor lists it in "
                    f"ENGINE_ADMIT_EXCLUDED"))
            if f not in frozen and f not in engine_excluded:
                findings.append(Finding(
                    engine_rel, admit.lineno, RULE,
                    f"_pool_admit_run never tree_freeze-s occupied lanes "
                    f"of per-lane field '{f}' (admission would clobber "
                    f"in-flight lanes)"))

    # ---- GQLState: ctor completeness ----------------------------------
    gfields = tuple(gql_mod.GQLState._fields)
    gql_ctors = _ctor_calls(gql_tree, "GQLState")
    if not gql_ctors:
        findings.append(Finding(
            gql_rel, 1, RULE, "no GQLState construction sites found"))
    for call in gql_ctors:
        kwargs = {kw.arg for kw in call.keywords if kw.arg}
        for f in gfields:
            if f not in kwargs:
                findings.append(Finding(
                    gql_rel, call.lineno, RULE,
                    f"GQLState(...) omits field '{f}' — the recurrence "
                    f"update must thread every field explicitly"))

    # ---- CoeffHistory: walkable dataclass + writer ---------------------
    cfields = tuple(f.name for f in
                    dataclasses.fields(matfun_mod.CoeffHistory))
    cline = _class_line(matfun_tree, "CoeffHistory")
    findings.extend(_walkable(matfun_mod.CoeffHistory, "CoeffHistory",
                              matfun_rel, cline, "freeze/shard/bank"))
    coeff_excluded = _tuple_literal(matfun_mod,
                                    "COEFF_REPLACE_EXCLUDED") or ()
    if _tuple_literal(matfun_mod, "COEFF_REPLACE_EXCLUDED") is None:
        findings.append(Finding(
            matfun_rel, cline, RULE,
            "`COEFF_REPLACE_EXCLUDED` registry missing from "
            "core/matfun.py (fields the per-step writer deliberately "
            "never rewrites)"))
    upd = _find_def(matfun_tree, "update_coeffs")
    if upd is None:
        findings.append(Finding(
            matfun_rel, cline, RULE,
            "update_coeffs not found (the coefficient writer)"))
    else:
        written: set = set()
        for node in ast.walk(upd):
            if isinstance(node, ast.Call) \
                    and _call_name(node) == "replace":
                written.update(kw.arg for kw in node.keywords if kw.arg)
        for f in cfields:
            if f not in written and f not in coeff_excluded:
                findings.append(Finding(
                    matfun_rel, upd.lineno, RULE,
                    f"update_coeffs neither writes CoeffHistory field "
                    f"'{f}' nor lists it in COEFF_REPLACE_EXCLUDED"))

    # ---- BlockState: walkable dataclass + step writer ------------------
    # The block-Krylov recurrence state (core/block.py, DESIGN.md
    # Sec. 13) rides QuadState.st through the same freeze/shard/resume
    # handlers as GQLState; its per-step writer is `block_step`'s
    # dataclasses.replace. A field the freeze walkers skip would
    # silently fall out of the state; one the writer neither rewrites
    # nor excludes would go stale across steps.
    try:
        block_mod = _import_role(roles, "block")
    except Exception as e:  # pragma: no cover - import environment broken
        rel, _ = _parse(roles, "block")
        findings.append(Finding(rel, 1, RULE,
                                f"cannot import repro_torch.core.block to "
                                f"read the live BlockState fields: {e!r}"))
        return findings
    block_rel, block_tree = _parse(roles, "block")
    bfields = tuple(f.name for f in
                    dataclasses.fields(block_mod.BlockState))
    bline = _class_line(block_tree, "BlockState")
    findings.extend(_walkable(block_mod.BlockState, "BlockState", block_rel,
                              bline, "freeze/shard/resume"))
    block_excluded = _tuple_literal(block_mod,
                                    "BLOCK_REPLACE_EXCLUDED") or ()
    if _tuple_literal(block_mod, "BLOCK_REPLACE_EXCLUDED") is None:
        findings.append(Finding(
            block_rel, bline, RULE,
            "`BLOCK_REPLACE_EXCLUDED` registry missing from "
            "core/block.py (fields the per-step writer deliberately "
            "never rewrites)"))
    bstep = _find_def(block_tree, "block_step")
    if bstep is None:
        findings.append(Finding(
            block_rel, bline, RULE,
            "block_step not found (the block recurrence writer)"))
    else:
        written = set()
        for node in ast.walk(bstep):
            if isinstance(node, ast.Call) \
                    and _call_name(node) in ("replace", "BlockState"):
                written.update(kw.arg for kw in node.keywords if kw.arg)
        for f in bfields:
            if f not in written and f not in block_excluded:
                findings.append(Finding(
                    block_rel, bstep.lineno, RULE,
                    f"block_step neither writes BlockState field '{f}' "
                    f"nor lists it in BLOCK_REPLACE_EXCLUDED — the "
                    f"recurrence would silently carry a stale value"))

    # ---- ChainFactor: walkable dataclass + carry writers ---------------
    # The incremental-chain factor (core/update.py, DESIGN.md Sec. 12)
    # is carried through the chain's moves by its two writers; a field
    # the walkers skip or a writer does not rewrite would silently drop
    # out of the carry.
    try:
        update_mod = _import_role(roles, "update")
    except Exception as e:  # pragma: no cover - import environment broken
        rel, _ = _parse(roles, "update")
        findings.append(Finding(rel, 1, RULE,
                                f"cannot import repro_torch.core.update to "
                                f"read the live ChainFactor fields: {e!r}"))
        return findings
    update_rel, update_tree = _parse(roles, "update")
    ffields = tuple(f.name for f in
                    dataclasses.fields(update_mod.ChainFactor))
    fline = _class_line(update_tree, "ChainFactor")
    findings.extend(_walkable(update_mod.ChainFactor, "ChainFactor", update_rel,
                              fline, "the chain carry / accept-reject select"))
    factor_excluded = _tuple_literal(update_mod,
                                     "FACTOR_REPLACE_EXCLUDED") or ()
    if _tuple_literal(update_mod, "FACTOR_REPLACE_EXCLUDED") is None:
        findings.append(Finding(
            update_rel, fline, RULE,
            "`FACTOR_REPLACE_EXCLUDED` registry missing from "
            "core/update.py (fields the carry writers deliberately "
            "never rewrite)"))
    for writer in ("extend", "downdate"):
        fn = _find_def(update_tree, writer)
        if fn is None:
            findings.append(Finding(
                update_rel, fline, RULE,
                f"{writer} not found (a ChainFactor carry writer)"))
            continue
        written = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _call_name(node) in ("replace", "ChainFactor"):
                written.update(kw.arg for kw in node.keywords if kw.arg)
        for f in ffields:
            if f not in written and f not in factor_excluded:
                findings.append(Finding(
                    update_rel, fn.lineno, RULE,
                    f"{writer} neither writes ChainFactor field '{f}' "
                    f"nor lists it in FACTOR_REPLACE_EXCLUDED — the "
                    f"carry would silently keep a stale value"))
    return findings
