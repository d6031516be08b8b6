"""No module the benchmark runs is JAX or the JAX package, compared by
whole top-level names (the program's name begins with the JAX package's),
and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dlrm_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return list(HERE.rglob("*.py"))


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(ROOT)): sorted(set(_imports(p)) & FORBIDDEN)
           for p in _sources()}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    for p in (HERE / "reference").rglob("*.py"):
        names = set(_imports(p))
        assert not names & (FORBIDDEN | {"dlrm_tpu_torch", "benchmark"}), p


def test_the_names_compare_whole():
    assert "dlrm_tpu_torch".split(".")[0] not in FORBIDDEN


def test_a_dry_run_loads_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark import harness, spec\n"
        "for name in ('kaggle-fs128.serve-b16384.zipf',\n"
        "             'terabyte-mlperf.train-rowwise.zipf'):\n"
        "    harness.run_cell(spec.load_cell(name), 3, 0.2, True, 'cpu',\n"
        "                     tiny=True)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, found = out.stdout.strip().splitlines()[-2:]
    assert found == "[]", loaded
    assert "'dlrm_tpu_torch'" in loaded
