"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference and the yardstick import nothing of the program."""

import ast
import subprocess
import sys

from benchmark.lib import spec

# the benchmark's own files that must not import the program
INDEPENDENT = ("reference/*.py", "lib/weights.py", "lib/data.py",
               "lib/counts.py", "lib/trace.py", "lib/spec.py",
               "metrics/*.py")

DRIVE = """
import sys
from benchmark.run import execute, forbidden_modules
from benchmark.tests import tiny
for kind in ("train_step", "decode"):
    r = tiny.run(kind, {}, seconds=0.05, trace=True)
    execute(r)
print("FORBIDDEN", forbidden_modules())
print("PORT", "neuspeech1_tpu_torch" in sys.modules)
"""


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_independent_files_import_no_program():
    files = [p for pattern in INDEPENDENT
             for p in spec.BENCH_DIR.glob(pattern)]
    assert len(files) > 10
    for path in files:
        bad = imported(path) & {"neuspeech1_tpu_torch", "neuspeech1_tpu",
                                "jax", "jaxlib", "flax"}
        assert not bad, (path, bad)


def test_no_file_imports_jax():
    for path in spec.BENCH_DIR.rglob("*.py"):
        assert not imported(path) & {"neuspeech1_tpu", "jax", "jaxlib",
                                     "flax"}, path


def test_a_drive_of_both_kinds_loads_no_jax():
    env_python = sys.executable
    out = subprocess.run([env_python, "-c", DRIVE], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
    assert "PORT True" in out.stdout


def test_forbidden_names_compare_whole():
    from benchmark.run import forbidden_modules

    assert forbidden_modules(["neuspeech1_tpu_torch.models.whisper",
                              "numpy", "jaxtyping"]) == []
    assert forbidden_modules(["neuspeech1_tpu.models", "jax._src.core",
                              "flax"]) == ["flax", "jax", "neuspeech1_tpu"]
