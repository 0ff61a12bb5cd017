"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"solver.py", "operators.py", "gql.py", "lanczos.py",
            "lanczos_step.py", "gql_update.py", "spmv_bell.py", "ops.py",
            "convert.py", "chip_smoke.py"} <= names
    rel = {str(p.relative_to(REPO / "src" / "repro_torch"))
           for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"tree.py", "configs/base.py", "configs/olmo_1b.py",
            "models/common.py", "models/attention.py", "models/losses.py",
            "models/model.py", "optim/adamw.py", "checkpoint/io.py",
            "data/synthetic.py", "data/dpp_selection.py", "train/loop.py",
            "train/monitor.py", "launch/steps.py",
            "launch/train.py"} <= rel


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [f"{path.relative_to(REPO)}:{line} imports {name}"
           for line, name in _imports(path) if _banned(name)]
    assert not bad, "\n".join(bad)


def test_import_needs_no_gpu_or_compiler():
    """Importing the package builds nothing and touches no card."""
    import repro_torch
    from repro_torch.kernels import _build

    assert repro_torch.LAUNCHES == {k: 0 for k in repro_torch.LAUNCHES} \
        or all(isinstance(v, int) for v in repro_torch.LAUNCHES.values())
    assert _build._LIBS == {} or all(_build._LIBS)
    for sub in ("checkpoint", "configs", "models", "optim", "train",
                "tree"):
        assert hasattr(repro_torch, sub)
    assert {p.name for p in _build.sources()} == {
        "gql_update.cu", "bell.cu", "dense_step.cu", "bell_mrhs.cu",
        "bilinear_matvec.cu", "flash_attention.cu"}
