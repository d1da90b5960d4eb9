"""Nothing of JAX or of the JAX package (whole top-level names:
``fgs_nerf_tpu_torch`` is not ``fgs_nerf_tpu``) is imported by the
benchmark; the reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["fgs_nerf_tpu_torch.models", "numpy"]) == []
    assert harness.forbidden_modules(["fgs_nerf_tpu.ops", "jax.numpy", "jaxlib"]) == [
        "fgs_nerf_tpu", "jax", "jaxlib"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "fgs_nerf_tpu_torch" not in tops, path


def test_a_tiny_cpu_cell_loads_no_jax():
    code = (
        "import sys\n"
        "from benchmark import harness\n"
        "import benchmark.reference.sdf_step\n"
        "from benchmark.tests.tiny import tiny_cell\n"
        "D, cell = tiny_cell('shiny_blender', 'fine_train')\n"
        "rec = D.run(cell, 0.2)\n"
        "assert rec['e2e']['units'] >= 1\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
