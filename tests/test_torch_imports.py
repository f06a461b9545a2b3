"""Import guard: the port and chip_smoke.py never import JAX or the JAX
package, and never call torch.compile."""
import ast
import pathlib

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
         + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])
BANNED_ROOTS = ("jax", "jaxlib", "repro")


def _banned(module: str) -> bool:
    return module.split(".")[0] in BANNED_ROOTS


def violations(source: str):
    """(line, what) for every banned import or torch.compile in ``source``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _banned(node.module):
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call):
            fn, args = node.func, node.args
            if (isinstance(fn, (ast.Name, ast.Attribute)) and args
                    and getattr(fn, "id", getattr(fn, "attr", "")) in
                    ("__import__", "import_module")
                    and isinstance(args[0], ast.Constant)
                    and isinstance(args[0].value, str) and _banned(args[0].value)):
                found.append((node.lineno, args[0].value))
            if (isinstance(fn, ast.Attribute) and fn.attr == "compile"
                    and isinstance(fn.value, ast.Name) and fn.value.id == "torch"):
                found.append((node.lineno, "torch.compile"))
        elif isinstance(node, ast.JoinedStr):
            # dynamic imports built from an f-string must name the port
            head = "".join(v.value for v in node.values
                           if isinstance(v, ast.Constant))
            if head.startswith("repro."):
                found.append((node.lineno, head))
    return found


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert violations(path.read_text()) == [], path


@pytest.mark.parametrize("src", [
    "import jax\n", "import jaxlib.xla_client\n", "from repro.models import moe\n",
    "import repro.kernels.ops as o\n", "import importlib\nimportlib.import_module('repro.core')\n",
    "import torch\nf = torch.compile(lambda x: x)\n",
    "from repro.analysis import runtime\n", "from repro import faults\n",
    "import repro.faults.plan\n", "from repro.analysis.lint import check_source\n",
])
def test_guard_flags_banned_code(src):
    assert violations(src)


def test_guard_scans_the_analysis_and_faults_packages():
    """The port's own analysis and faults packages are among the scanned
    files (they are copies of reference modules, never imports of them)."""
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").parts[0] for p in FILES
               if p.is_relative_to(ROOT / "src" / "repro_torch")}
    assert {"analysis", "faults"} <= scanned


@pytest.mark.parametrize("path", ["distributed/__init__.py", "distributed/ep_engine.py",
                                  "distributed/replicas.py", "sharding/specs.py",
                                  "launch/mesh.py"])
def test_guard_scans_the_distributed_modules(path):
    """The distributed slice's modules (copies of the reference's
    ``distributed``, ``sharding`` and ``launch`` modules' logic, never
    imports of them) are among the scanned files."""
    assert ROOT / "src" / "repro_torch" / path in FILES


@pytest.mark.parametrize("path", ["src/repro_torch/launch/dryrun.py",
                                  "src/repro_torch/launch/trace_analysis.py",
                                  "src/repro_torch/launch/roofline.py",
                                  *[f"examples/torch_{name}.py" for name in (
                                      "quickstart", "offline_serve", "omega_split",
                                      "serve_online", "serve_prefix_cache", "serve_mesh",
                                      "train_small")]])
def test_guard_scans_the_compile_analysis_and_the_examples(path):
    """The dry run, trace analysis and roofline (counterparts of the
    reference's ``launch`` modules) and the port's examples are scanned."""
    assert ROOT / path in FILES


def test_guard_allows_the_port():
    assert violations("import repro_torch.models.moe\nfrom repro_torch import bridge\n") == []
