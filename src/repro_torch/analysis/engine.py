"""quadlint engine for the port: findings, suppressions, file walking,
rule dispatch (counterpart of ``repro.analysis.engine``).

The engine is dependency-free (stdlib ``ast`` + ``re``): per-file rules
(rules_ast.py, collectives.py) parse one file at a time, and the
cross-file state-threading checker (contracts.py) runs once per
invocation when the port's ``core/solver.py`` is in the scan set.
Findings print as ``path:line RULE message`` and the CLI exits 1 when
any survive suppression, 0 otherwise: the reference's format and codes.

Suppression syntax, the reference's::

    dist.broadcast(out, src)  # quadlint: disable=QL007 -- why it is fine

The comment silences the named rule(s) on its own line and on the line
directly below it (for comments placed above a long statement). The
reason after ``--`` is REQUIRED: a bare ``disable=`` is itself a finding
(QL000), and QL000 cannot be suppressed.
"""
from __future__ import annotations

import ast
import os
import re
from pathlib import Path
from typing import Callable, Iterable, NamedTuple, Optional

SUPPRESSION_RULE = "QL000"

_SUPPRESS_RE = re.compile(
    r"#\s*quadlint:\s*disable=(?P<rules>[A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)"
    r"(?P<reason>\s*--\s*\S.*)?")


class Finding(NamedTuple):
    """One rule violation, anchored to a source line."""
    path: str     # display path (relative to the invocation cwd)
    line: int     # 1-based
    rule: str     # "QLxxx"
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


class FileContext(NamedTuple):
    """Everything a per-file rule needs about one parsed source file."""
    path: Path    # resolved absolute path
    rel: str      # display path
    source: str
    tree: ast.Module

    @property
    def parts(self) -> tuple:
        return self.path.parts

    @property
    def in_src(self) -> bool:
        """Library code: anything under a directory named ``src``."""
        return "src" in self.parts

    @property
    def in_serve(self) -> bool:
        return self.in_src and "serve" in self.parts

    @property
    def in_tests(self) -> bool:
        return "tests" in self.parts


def parse_suppressions(source: str, rel: str
                       ) -> tuple[dict[int, set], list]:
    """Scan COMMENT tokens for ``# quadlint: disable=...`` directives
    (tokenize-based, so docstrings/strings describing the syntax never
    count as directives).

    Returns (line -> suppressed rule set, findings for malformed
    suppressions). A suppression covers its own line and the next one.
    """
    import io
    import tokenize

    suppressed: dict[int, set] = {}
    findings: list[Finding] = []
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError):  # load_context reports it
        return suppressed, findings
    for tok in tokens:
        if tok.type != tokenize.COMMENT or "quadlint" not in tok.string:
            continue
        lineno = tok.start[0]
        m = _SUPPRESS_RE.search(tok.string)
        if m is None:
            if "quadlint:" in tok.string:
                findings.append(Finding(
                    rel, lineno, SUPPRESSION_RULE,
                    "malformed quadlint directive (expected "
                    "'# quadlint: disable=QLxxx -- reason')"))
            continue
        rules = {r.strip() for r in m.group("rules").split(",")}
        if not m.group("reason"):
            findings.append(Finding(
                rel, lineno, SUPPRESSION_RULE,
                "suppression requires a reason: "
                "'# quadlint: disable=" + ",".join(sorted(rules))
                + " -- why the rule does not apply here'"))
            continue
        for covered in (lineno, lineno + 1):
            suppressed.setdefault(covered, set()).update(rules)
    return suppressed, findings


def collect_files(paths: Iterable[str]) -> list[Path]:
    """Expand files/directories into a sorted, de-duplicated .py list."""
    out: dict[Path, None] = {}
    for raw in paths:
        p = Path(raw)
        if not p.exists():
            raise FileNotFoundError(f"quadlint: no such path: {raw}")
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" not in f.parts:
                    out[f.resolve()] = None
        else:
            out[p.resolve()] = None
    return list(out)


def _display(path: Path) -> str:
    try:
        rel = os.path.relpath(path)
    except ValueError:  # different drive (windows); keep absolute
        return str(path)
    return str(path) if rel.startswith("..") else rel


def load_context(path: Path) -> tuple[Optional[FileContext], list]:
    rel = _display(path)
    source = path.read_text(encoding="utf-8")
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return None, [Finding(rel, e.lineno or 1, SUPPRESSION_RULE,
                              f"file does not parse: {e.msg}")]
    return FileContext(path=path, rel=rel, source=source, tree=tree), []


def _file_rules() -> list[Callable[[FileContext], Iterable[Finding]]]:
    # imported lazily so `load_context` has no circular dependency
    from . import collectives, rules_ast
    return [
        rules_ast.check_shim_imports,      # QL005
        rules_ast.check_randomness,        # QL006
        rules_ast.check_host_telemetry,    # QL008
        collectives.check_collective_cadence,  # QL007
    ]


def run_paths(paths: Iterable[str], *,
              project_checks: bool = True) -> list:
    """Run every rule over ``paths``; returns unsuppressed findings
    sorted by (path, line, rule)."""
    files = collect_files(paths)
    rules = _file_rules()
    findings: list[Finding] = []
    suppressions: dict[str, dict[int, set]] = {}
    contexts: list[FileContext] = []
    for path in files:
        ctx, parse_findings = load_context(path)
        findings.extend(parse_findings)
        if ctx is None:
            continue
        contexts.append(ctx)
        supp, supp_findings = parse_suppressions(ctx.source, ctx.rel)
        suppressions[ctx.rel] = supp
        findings.extend(supp_findings)
        for rule in rules:
            findings.extend(rule(ctx))
    if project_checks:
        from . import contracts
        findings.extend(contracts.check_contracts(contexts))

    def keep(f: Finding) -> bool:
        if f.rule == SUPPRESSION_RULE:  # QL000 cannot be suppressed
            return True
        return f.rule not in suppressions.get(f.path, {}).get(f.line, ())

    kept = sorted({f for f in findings if keep(f)},
                  key=lambda f: (f.path, f.line, f.rule, f.message))
    return kept


def main(argv: Optional[list] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="quadlint for the PyTorch port: static checks of its "
                    "state-threading, randomness, capture and collective "
                    "contracts")
    parser.add_argument("paths", nargs="+",
                        help="files or directories to scan")
    parser.add_argument("--no-project-checks", action="store_true",
                        help="skip the cross-file state-threading checker "
                             "(QL001)")
    args = parser.parse_args(argv)
    findings = run_paths(args.paths,
                         project_checks=not args.no_project_checks)
    for f in findings:
        print(f.render())
    if findings:
        print(f"quadlint: {len(findings)} finding(s)")
        return 1
    return 0
