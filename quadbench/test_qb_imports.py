"""What the harness loads, checked in fresh processes: no module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX
package; ``repro_torch``, the port, passes); the reference imports nothing
of the program; and ``run.py`` refuses to run without a card, or without
the program beside it, printing no result."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

LOAD_ALL = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import importlib.util, pathlib
{imports}
print(json.dumps(sorted(sys.modules)))
"""


def _modules(imports: str) -> set:
    code = LOAD_ALL.format(src=str(ROOT / "src"), root=str(ROOT),
                           imports=imports)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_loads_no_jax():
    # everything run.py imports, every metric reader, and the program
    mods = _modules("""
import repro_torch, repro_torch.core, repro_torch.kernels
from quadbench import harness, readers, reckon, reference, traffic
for p in sorted(pathlib.Path({root!r}, 'quadbench', 'metrics').glob('*.py')):
    harness.reader(p.stem)
""".replace("{root!r}", repr(str(ROOT))))
    assert "repro_torch" in mods and "quadbench.harness" in mods
    bad = sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)
    assert bad == []


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules("from quadbench import reference")
    assert not any(m.split(".")[0] in FORBIDDEN | {"repro_torch"}
                   for m in mods)


def _run(cwd: Path, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "quadbench/run.py", "--workload", "rbf-gp-variance",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=env, cwd=cwd)


def test_run_refuses_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "quadbench", tmp_path / "quadbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
