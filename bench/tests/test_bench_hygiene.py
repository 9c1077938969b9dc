"""Nothing the benchmark loads is JAX or the JAX package, and the plain
references load nothing of the program (top-level names compared whole:
``repro_torch`` begins with ``repro``)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"

IMPORT_ALL = """
import importlib, importlib.util, sys
from pathlib import Path
bench = Path(sys.argv[1])
done = 0
for path in sorted(bench.rglob('*.py')):
    rel = path.relative_to(bench.parent)
    if 'tests' in rel.parts:
        continue
    name = '.'.join(rel.with_suffix('').parts).replace('.__init__', '')
    if '.metrics.' in name:
        spec = importlib.util.spec_from_file_location(name.replace('.', '_'), path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(name)
    done += 1
bad = sorted(m for m in sys.modules if m.split('.')[0] in sys.argv[2].split(','))
print(done)
print(' '.join(bad))
"""


def _run(code, *args, extra_path=()):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *map(str, extra_path)]))
    return subprocess.run([sys.executable, "-c", code, *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_bench_module_leaves_jax_out():
    out = _run(IMPORT_ALL, str(BENCH), "jax,jaxlib,flax,repro",
               extra_path=[ROOT / "src"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert int(lines[0]) == len(files)
    assert lines[1].strip() == ""


def test_run_leaves_jax_out_after_a_run():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
            "from bench.tests.small import run_small\n"
            "from bench import harness\n"
            "r, h = run_small('mig-pod64.stream', 3, seconds=0.5)\n"
            "print(harness.forbidden_modules())\n")
    out = _run(code, str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_references_load_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax"), (path, n)
    code = ("import sys, importlib\n"
            "for m in ('auction', 'mamba'):\n"
            "    importlib.import_module('bench.reference.' + m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
