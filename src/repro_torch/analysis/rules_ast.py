"""Per-file AST rules of the port: shim imports, unkeyed randomness,
host-side-only telemetry (QL005 / QL006 / QL008; counterpart of
``repro.analysis.rules_ast``).

Every rule here works on one parsed file at a time and knows nothing
about the runtime beyond naming conventions (the cross-file contracts
live in contracts.py). QL002 and QL003 have no counterpart: eager torch
has no trace, so a Python ``if`` on a tensor reads its value (a host
sync, not a leaked tracer), and no jit cache is built per call.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from .engine import FileContext, Finding

# ---------------------------------------------------------------------------
# shared helpers


def dotted(node: ast.AST) -> Optional[str]:
    """'torch.distributed.all_reduce' for an attribute chain, or None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def last_component(node: ast.AST) -> Optional[str]:
    d = dotted(node)
    return None if d is None else d.rsplit(".", 1)[-1]


_FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _walk_pruned(nodes) -> Iterable[ast.AST]:
    """Walk statements WITHOUT descending into nested function
    definitions."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _FunctionNode):
            stack.extend(ast.iter_child_nodes(node))


def _body(fn) -> list:
    return fn.body if isinstance(fn.body, list) else [fn.body]


def _defs_by_name(tree: ast.Module) -> dict:
    out: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out


# ---------------------------------------------------------------------------
# QL005: the removed deprecation shims stay removed

_BANNED_FUNCTIONS = {"bif_bounds", "bif_refine_until", "judge_threshold",
                     "judge_kdpp_swap", "judge_double_greedy",
                     "preconditioned_bif_bounds"}
_BANNED_MODULES = {"deprecation", "judge", "precond"}


def check_shim_imports(ctx: FileContext) -> Iterable[Finding]:
    """QL005 (library code only): no imports of the deleted
    deprecation shims (DESIGN.md Sec. 5 removal schedule) -- callers use
    ``BIFSolver.create(...)`` methods."""
    if not ctx.in_src:
        return []
    findings: list = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            from_repro = node.level > 0 or mod.startswith("repro")
            if from_repro and mod.rsplit(".", 1)[-1] in _BANNED_MODULES:
                findings.append(Finding(
                    ctx.rel, node.lineno, "QL005",
                    f"import from removed shim module '{mod}' (deleted "
                    f"per DESIGN.md Sec. 5; use BIFSolver)"))
                continue
            for alias in node.names:
                if from_repro and alias.name in _BANNED_FUNCTIONS:
                    findings.append(Finding(
                        ctx.rel, node.lineno, "QL005",
                        f"import of removed shim `{alias.name}` (use the "
                        f"BIFSolver.create(...) equivalent)"))
                elif from_repro and alias.name in _BANNED_MODULES:
                    findings.append(Finding(
                        ctx.rel, node.lineno, "QL005",
                        f"import of removed shim module "
                        f"`{alias.name}` (deleted per DESIGN.md Sec. 5)"))
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith("repro") and \
                        alias.name.rsplit(".", 1)[-1] in _BANNED_MODULES:
                    findings.append(Finding(
                        ctx.rel, node.lineno, "QL005",
                        f"import of removed shim module '{alias.name}'"))
    return findings


# ---------------------------------------------------------------------------
# QL006: unkeyed randomness

_ALLOWED_NP_RANDOM = {"default_rng", "Generator", "SeedSequence", "PCG64",
                      "Philox", "SFC64", "BitGenerator"}
# torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial", "poisson", "rand_like",
                   "randn_like", "randint_like"}
# in-place samplers on a tensor
_TORCH_INPLACE = {"normal_", "uniform_", "bernoulli_", "random_",
                  "exponential_", "cauchy_", "log_normal_", "geometric_"}
# seeding torch's process-global generators
_TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed",
                      "torch.random.manual_seed",
                      "torch.random.seed", "torch.cuda.manual_seed",
                      "torch.cuda.manual_seed_all", "torch.cuda.seed",
                      "torch.cuda.seed_all"}


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


def check_randomness(ctx: FileContext) -> Iterable[Finding]:
    """QL006 (library + benchmark code; tests may do as they like):
    randomness must flow from an explicit seed. numpy's legacy
    global-state ``np.random.*``, argless ``default_rng()`` and the stdlib
    ``random`` module draw OS entropy or process-global state; so do
    torch's samplers without ``generator=`` (``torch.rand`` / ``randn`` /
    ``randint`` / ``randperm`` / ``normal`` / ``bernoulli`` /
    ``multinomial`` / ``*_like``, and in-place ``.normal_`` /
    ``.uniform_`` / ``.bernoulli_`` / ``.random_`` / ``.exponential_``),
    and seeding torch's global generators (``torch.manual_seed``,
    ``torch.cuda.manual_seed*``, ``torch.seed``) couples every draw of the
    process to one hidden state. Draw from a ``torch.Generator`` seeded by
    the caller."""
    if ctx.in_tests:
        return []
    findings: list = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d is None:
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _TORCH_INPLACE \
                        and not _has_generator(node):
                    findings.append(_inplace_finding(ctx, node))
                continue
            parts = d.split(".")
            if len(parts) >= 3 and parts[-2] == "random" \
                    and parts[-3] in ("np", "numpy") \
                    and parts[-1] not in _ALLOWED_NP_RANDOM:
                findings.append(Finding(
                    ctx.rel, node.lineno, "QL006",
                    f"legacy global-state `{d}(...)` (use a seeded "
                    f"np.random.default_rng)"))
            elif parts[-1] == "default_rng" and not node.args \
                    and not node.keywords:
                findings.append(Finding(
                    ctx.rel, node.lineno, "QL006",
                    "argless default_rng() draws an OS seed; pass an "
                    "explicit seed"))
            elif d in _TORCH_GLOBAL_SEED:
                findings.append(Finding(
                    ctx.rel, node.lineno, "QL006",
                    f"`{d}(...)` seeds torch's process-global generator; "
                    f"draw from a torch.Generator seeded by the caller"))
            elif len(parts) == 2 and parts[0] == "torch" \
                    and parts[1] in _TORCH_SAMPLERS \
                    and not _has_generator(node):
                findings.append(Finding(
                    ctx.rel, node.lineno, "QL006",
                    f"`{d}(...)` without generator= draws from torch's "
                    f"global generator; pass a seeded torch.Generator"))
            elif parts[-1] in _TORCH_INPLACE and len(parts) >= 2 \
                    and not _has_generator(node):
                findings.append(_inplace_finding(ctx, node))
        elif isinstance(node, ast.Import):
            if any(alias.name == "random" for alias in node.names):
                findings.append(Finding(
                    ctx.rel, node.lineno, "QL006",
                    "stdlib `random` is process-global and unseeded here; "
                    "use np.random.default_rng(seed) or a torch.Generator"))
        elif isinstance(node, ast.ImportFrom) and node.module == "random" \
                and node.level == 0:
            findings.append(Finding(
                ctx.rel, node.lineno, "QL006",
                "stdlib `random` is process-global and unseeded here; "
                "use np.random.default_rng(seed) or a torch.Generator"))
    return findings


def _inplace_finding(ctx: FileContext, node: ast.Call) -> Finding:
    return Finding(
        ctx.rel, node.lineno, "QL006",
        f"in-place `.{node.func.attr}(...)` without generator= draws from "
        f"torch's global generator; pass a seeded torch.Generator")


# ---------------------------------------------------------------------------
# QL008: host-side-only telemetry (obs.metrics / obs.spans / print)


def _obs_banned_refs(tree: ast.Module) -> tuple:
    """Resolve this file's import aliases for the BANNED obs modules.

    Returns (prefixes, names): ``prefixes`` are dotted call prefixes that
    denote obs.metrics / obs.spans modules (calls on their attributes are
    banned in captured scopes), ``names`` are directly-imported callables
    from them. ``obs.registry`` is deliberately absent.
    """
    prefixes: set = set()
    names: set = set()

    def classify(full_parts: list, bound: str, is_from: bool) -> None:
        if "obs" not in full_parts:
            return
        tail = full_parts[full_parts.index("obs") + 1:]
        if not tail:
            prefixes.add(f"{bound}.metrics")
            prefixes.add(f"{bound}.spans")
        elif tail[0] in ("metrics", "spans"):
            if len(tail) == 1:
                prefixes.add(bound)
            elif is_from:
                names.add(bound)

    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = (node.module or "").split(".") if node.module else []
            for alias in node.names:
                bound = alias.asname or alias.name
                classify(mod + alias.name.split("."), bound, True)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                parts = alias.name.split(".")
                classify(parts, alias.asname or alias.name, False)
    return prefixes, names


_COMPILE = {"torch.compile"}
_GRAPH_CTX = {"torch.cuda.graph", "cuda.graph", "graph"}
_GRAPHED = {"make_graphed_callables"}


def _is_compile(node: ast.AST) -> bool:
    """``torch.compile`` or ``torch.compile(...)`` (a decorator or a
    call)."""
    if dotted(node) in _COMPILE:
        return True
    return isinstance(node, ast.Call) and dotted(node.func) in _COMPILE


def _fn_args(node: ast.Call, by_name: dict) -> list:
    """The function nodes named (or given as lambdas) among a call's
    arguments; tuples and lists of them too."""
    out: list = []
    stack = list(node.args) + [kw.value for kw in node.keywords]
    while stack:
        a = stack.pop()
        if isinstance(a, ast.Lambda):
            out.append(a)
        elif isinstance(a, ast.Name):
            out.extend(by_name.get(a.id, ()))
        elif isinstance(a, (ast.Tuple, ast.List)):
            stack.extend(a.elts)
    return out


class _Region(ast.AST):
    """Statements captured between ``capture_begin()`` and
    ``capture_end()``, or under ``with torch.cuda.graph(...)``, scanned as
    if they were a function body."""
    _fields = ("body",)

    def __init__(self, body):
        super().__init__()
        self.body = body


def _captured_roots(tree: ast.Module, by_name: dict) -> list:
    """The captured scopes of a module: ``torch.compile``d functions
    (decorated, or passed to ``torch.compile``), the callables given to
    ``make_graphed_callables``, the bodies of ``with torch.cuda.graph``
    blocks and the statements between a graph's ``capture_begin()`` and
    ``capture_end()``."""
    roots: list = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_is_compile(d) for d in node.decorator_list):
                roots.append(node)
        elif isinstance(node, ast.Call):
            if dotted(node.func) in _COMPILE \
                    or last_component(node.func) in _GRAPHED:
                roots.extend(_fn_args(node, by_name))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(isinstance(it.context_expr, ast.Call)
                   and dotted(it.context_expr.func) in _GRAPH_CTX
                   for it in node.items):
                roots.append(_Region(node.body))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Module, ast.With, ast.For, ast.While,
                             ast.If, ast.Try)):
            roots.extend(_capture_regions(node))
    return roots


def _capture_regions(block) -> list:
    """Runs of statements of one block between ``<g>.capture_begin()``
    and ``<g>.capture_end()``."""
    out: list = []
    for attr in ("body", "orelse", "finalbody"):
        stmts = getattr(block, attr, None)
        if not isinstance(stmts, list):
            continue
        start = None
        for i, st in enumerate(stmts):
            call = st.value if isinstance(st, ast.Expr) else None
            name = last_component(call.func) \
                if isinstance(call, ast.Call) else None
            if name == "capture_begin":
                start = i + 1
            elif name == "capture_end" and start is not None:
                out.append(_Region(stmts[start:i]))
                start = None
    return out


def check_host_telemetry(ctx: FileContext) -> Iterable[Finding]:
    """QL008 (library code only): obs.metrics / obs.spans calls and
    ``print()`` must not be reachable inside a captured scope: a CUDA
    graph's capture (``with torch.cuda.graph(...)``, ``capture_begin()``
    to ``capture_end()``, the callables given to
    ``make_graphed_callables``) or a ``torch.compile``d function, with
    the same-module helpers they call.

    Python side effects there run once, at capture (or compile): a
    replay or a compiled call repeats the kernels and none of the
    Python, so a counter counts captures, a span times the capture, a
    print shows the first call's values -- all three silently lie.
    Telemetry is host-side by contract (DESIGN.md Sec. 14)."""
    if not ctx.in_src:
        return []
    prefixes, names = _obs_banned_refs(ctx.tree)
    by_name = _defs_by_name(ctx.tree)
    roots = _captured_roots(ctx.tree, by_name)
    if not roots:
        return []

    scanned: list = []
    seen: set = set()
    queue = list(roots)
    while queue:
        fn = queue.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        scanned.append(fn)
        for node in _walk_pruned(_body(fn)):
            if isinstance(node, _FunctionNode):
                queue.append(node)   # nested def: captured when called
                continue
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name):
                queue.extend(by_name.get(node.func.id, ()))

    findings: list = []
    for fn in scanned:
        for node in _walk_pruned(_body(fn)):
            if isinstance(node, _FunctionNode) or \
                    not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d is None:
                continue
            if d == "print":
                findings.append(Finding(
                    ctx.rel, node.lineno, "QL008",
                    "print() inside a captured scope (CUDA graph / "
                    "torch.compile) runs once, at capture; log "
                    "host-side"))
            elif d in names or any(d == p or d.startswith(p + ".")
                                   for p in prefixes):
                findings.append(Finding(
                    ctx.rel, node.lineno, "QL008",
                    f"`{d}(...)` inside a captured scope (CUDA graph / "
                    f"torch.compile): obs.metrics/obs.spans are "
                    f"host-side-only (they would record the capture "
                    f"once, not each replay)"))
    return findings
