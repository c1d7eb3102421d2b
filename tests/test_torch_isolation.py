"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package.

Checked two ways: importing every port module in a fresh interpreter
leaves no ``jax``/``repro`` module loaded, and no import statement in the
port's sources (or the smoke script) names them.  The modules the port
keeps as verbatim copies (``COPIES``) must equal the reference's sources
with only their imports re-pointed; those it extends (``EXTENDED``) must
keep every line of the reference's code, in order, and add to the
reference's functions nothing but wall-clock spans.
"""
from __future__ import annotations

import ast
import difflib
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
# Copies the port extends with lines of its own (the telemetry hub's
# wall-clock spans and the writer's backpressure span): every line of the
# reference stays, in order, and the only lines changed or dropped lie in
# docstrings on both sides.  Besides, the code is the reference's once
# what the port may add is taken out (``_without_span_additions``).
EXTENDED = {"core/telemetry.py", "core/writer.py"}
SPAN_CALLS = {"span", "add_span"}
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _span_addition(stmt) -> bool:
    """A statement the port may add inside the reference's code: a call of
    ``<hub>.span``/``<hub>.add_span``, or the hub's ``spans`` ring."""
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        func = stmt.value.func
        return isinstance(func, ast.Attribute) and func.attr in SPAN_CALLS
    targets = (stmt.targets if isinstance(stmt, ast.Assign)
               else [stmt.target] if isinstance(stmt, ast.AnnAssign) else [])
    return any(isinstance(t, ast.Attribute) and t.attr == "spans"
               for t in targets)


def _code(source: str) -> ast.Module:
    """``source``'s tree without its docstrings."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module,) + _DEFS) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant) and isinstance(
                    first.value.value, str):
                node.body = node.body[1:] or [ast.Pass()]
    return tree


def _without_span_additions(want: ast.Module, got: ast.Module) -> ast.Module:
    """``got`` with what the port may add beside the reference ``want``
    taken out: imports and defs of its own at module and class level, and
    span calls and the span ring inside the reference's functions."""
    def scrub_code(body):
        out = []
        for stmt in body:
            if _span_addition(stmt):
                continue
            for field in ("body", "orelse", "finalbody"):
                if isinstance(getattr(stmt, field, None), list):
                    setattr(stmt, field, scrub_code(getattr(stmt, field)))
            if isinstance(stmt, ast.Try):
                for handler in stmt.handlers:
                    handler.body = scrub_code(handler.body)
            out.append(stmt)
        return out

    def scrub_scope(wbody, gbody, module):
        wdefs = {n.name: n for n in wbody if isinstance(n, _DEFS)}
        wimports = {ast.dump(n) for n in wbody
                    if isinstance(n, (ast.Import, ast.ImportFrom))}
        out = []
        for stmt in gbody:
            if isinstance(stmt, _DEFS):
                if stmt.name not in wdefs:
                    continue
                w = wdefs[stmt.name]
                stmt.body = (scrub_scope(w.body, stmt.body, False)
                             if isinstance(stmt, ast.ClassDef)
                             else scrub_code(stmt.body))
            elif module and isinstance(stmt, (ast.Import, ast.ImportFrom)) \
                    and ast.dump(stmt) not in wimports:
                continue
            out.append(stmt)
        return out

    got.body = scrub_scope(want.body, got.body, True)
    return got


def test_an_extended_copy_may_add_spans_and_nothing_else():
    ref = ("import time\n"
           "class Hub:\n"
           "    def put(self, x):\n"
           "        t0 = time.perf_counter()\n"
           "        self.q.append(x)\n"
           "        return t0\n")
    spans = ref.replace("import time\n", "import threading\nimport time\n") \
        .replace("        self.q.append(x)\n",
                 "        self.q.append(x)\n"
                 "        self.tel.add_span('put', t0)\n") \
        + "    def span(self, name):\n        return name\n"
    inserted_return = ref.replace("        t0 = time.perf_counter()\n",
                                  "        return None\n"
                                  "        t0 = time.perf_counter()\n")
    reassigned = ref.replace("        return t0\n",
                             "        self.q = []\n        return t0\n")
    want = ast.dump(_code(ref))

    def kept(src):
        return ast.dump(_without_span_additions(_code(ref), _code(src)))
    assert kept(spans) == want
    assert kept(inserted_return) != want
    assert kept(reassigned) != want


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
    want_src = (ROOT / "src" / "repro" / rel).read_text() \
        .replace("repro.", "repro_torch.")
    want = want_src.splitlines()
    got = (PORT / rel).read_text().splitlines()
    if rel in EXTENDED:
        want_doc = _docstring_lines(want_src)
        got_doc = _docstring_lines((PORT / rel).read_text())
        ops = difflib.SequenceMatcher(None, want, got,
                                      autojunk=False).get_opcodes()
        assert any(tag == "insert" for tag, *_ in ops)
        for tag, i1, i2, j1, j2 in ops:
            if tag in ("replace", "delete"):
                assert set(range(i1 + 1, i2 + 1)) <= want_doc, want[i1:i2]
                assert set(range(j1 + 1, j2 + 1)) <= got_doc, got[j1:j2]
        want_code = _code(want_src)
        got_code = _without_span_additions(
            want_code, _code((PORT / rel).read_text()))
        assert ast.dump(got_code) == ast.dump(want_code)
        return
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
