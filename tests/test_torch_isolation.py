"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package.

Checked two ways: importing every port module in a fresh interpreter
leaves no ``jax``/``repro`` module loaded, and no import statement in the
port's sources (or the smoke script) names them.  The modules the port
keeps as verbatim copies (``COPIES``) must equal the reference's sources
with only their imports re-pointed.
"""
from __future__ import annotations

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules() -> list:
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_port_imports_load_no_jax_and_no_reference():
    mods = _modules()
    assert "repro_torch.kernels.delta_encode.kernel" in mods
    assert "repro_torch.moe.moe" in mods
    assert "repro_torch.models.encdec" in mods
    assert "repro_torch.launch.dryrun" in mods
    examples = [str(p) for p in sorted((ROOT / "examples")
                                       .glob("torch_*.py"))]
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({examples!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.'))\n"
        "             or m == 'repro')\n"
        "print('BAD', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def _imported_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module)
    return names


# the examples written for the port, beside the reference's
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def test_no_source_names_jax_or_the_reference():
    assert [p.name for p in EXAMPLES] == [
        "torch_project_switch.py", "torch_quickstart.py",
        "torch_serve_capsule.py"]
    assert {"cell", "dryrun", "flop_analysis", "mesh"} <= {
        p.stem for p in (PORT / "launch").glob("*.py")}
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


# The framework-neutral modules the port keeps as copies of the JAX
# package's: each must equal the reference's source once ``repro.`` reads
# ``repro_torch.``.  ``REWORDED`` lists the only other edits, by line:
# docstring wording, each line checked to lie inside a docstring.
COPIES = sorted(
    [f"configs/{p.name}" for p in (ROOT / "src" / "repro" / "configs")
     .glob("*.py")]
    + [f"core/{m}.py" for m in ("telemetry", "chunkstore", "writer",
                                "scheduler", "control", "membership",
                                "replica", "sim", "edge", "shardplane",
                                "server")]
    + ["data/pipeline.py", "launch/costmodel.py"])
REWORDED = {"core/scheduler.py": {54}, "core/sim.py": {9, 49},
            "core/edge.py": {7}}


def _docstring_lines(source: str) -> set:
    lines = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant) and isinstance(
                    first.value.value, str):
                lines.update(range(first.lineno, first.end_lineno + 1))
    return lines


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_the_reference(rel):
    want = (ROOT / "src" / "repro" / rel).read_text() \
        .replace("repro.", "repro_torch.").splitlines()
    got = (PORT / rel).read_text().splitlines()
    assert len(got) == len(want)
    differ = {i + 1 for i, (a, b) in enumerate(zip(got, want)) if a != b}
    assert differ == REWORDED.get(rel, set())
    assert differ <= _docstring_lines((PORT / rel).read_text())


# import names whose distribution on PyPI is named otherwise
DISTRIBUTIONS = {"ml_dtypes": "ml-dtypes"}


def _requirement_names(path: Path) -> set:
    names = set()
    for line in path.read_text().splitlines():
        line = line.split("#")[0].strip()
        if line and not line.startswith("-"):
            names.add(re.split(r"[\[<>=!~; ]", line)[0].lower()
                      .replace("_", "-"))
    return names


def test_ci_installs_what_the_tests_import():
    """CI's test job runs ``pip install -r requirements.txt`` and then the
    tests: every third-party package that ``tests/*.py``, ``src/**/*.py``
    or ``chip_smoke.py`` imports (at any depth) must be named there, or
    pytest stops at collection."""
    files = sorted((ROOT / "tests").glob("*.py")) \
        + sorted((ROOT / "src").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    local = {p.stem for p in (ROOT / "tests").glob("*.py")} | {
        p.name for p in (ROOT / "src").iterdir()} | {"chip_smoke"}
    third_party = set()
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            if top not in sys.stdlib_module_names and top not in local:
                third_party.add(top)
    assert {"torch", "jax", "numpy", "pytest"} <= third_party
    wanted = {DISTRIBUTIONS.get(n, n).lower().replace("_", "-")
              for n in third_party}
    assert wanted <= _requirement_names(ROOT / "requirements.txt")
