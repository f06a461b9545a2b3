"""The import guard: nothing of the benchmark loads JAX, the JAX package, its
benchmarks or the smoke script; the reference's files load nothing of the
program either.  Top-level names compared whole: ``repro_torch`` is not
``repro``."""
import ast
import subprocess
import sys

import pytest

from bench import harness, spec

BARRED = {"jax", "jaxlib", "flax", "repro", "chip_smoke", "benchmarks"}
REFERENCE = ("spec", "traffic", "weights", "reference", "arith", "trace")
FILES = sorted(p for p in spec.BENCH.rglob("*.py"))


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.BENCH)))
def test_no_barred_import(path):
    assert not _imports(path) & BARRED


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_files_import_nothing_of_the_program(name):
    assert "repro_torch" not in _imports(spec.BENCH / f"{name}.py")


def test_loaded_modules_compared_whole():
    code = ("import sys; sys.path[:0] = [%r, %r]; import bench.reference, bench.traffic, "
            "bench.arith, bench.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(spec.ROOT), str(spec.ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (BARRED | {"repro_torch"})
    import repro_torch  # noqa: F401  (a name that merely begins with "repro")

    assert "repro" not in sys.modules
    assert harness.forbidden_modules() == []
