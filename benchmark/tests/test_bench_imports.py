"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pi_sph_fluid_tpu"}
BENCH = ROOT / "benchmark"


def _imports(path):
    """Top-level names of every absolute import, import_module() string
    and relative import (as '.') in a file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def _sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py")
            if "tests" not in p.relative_to(BENCH).parts and "__pycache__" not in p.parts]


def test_no_jax_anywhere_in_the_benchmark():
    srcs = _sources()
    assert len(srcs) > 10
    for p in srcs:
        assert not (_imports(p) & FORBIDDEN), p


def test_reference_imports_only_torch_and_numpy():
    for p in _sources("reference"):
        assert _imports(p) <= {"__future__", "math", "numpy", "torch", "."}, p


def test_loaded_modules_of_a_harness_import():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.harness, benchmark.run; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (str(ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
