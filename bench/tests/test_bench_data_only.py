"""A later change adds a cell, a configuration or a per-layer metric with
new files and new entries alone: run.py finds them by name, and the suite's
per-cell tests take a new cell, no file edited."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _copy(root: Path) -> None:
    """The benchmark's files alone under ``root``."""
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    _copy(tmp_path)
    before = _digests(tmp_path)
    b = tmp_path / "bench"
    cell = json.loads((b / "workloads" / "mig-pod64.stream.json").read_text())
    cell.update(name="mig-pod64.trickle", traffic="trickle")
    cell["params"].update(rate=2.0, warmup_t=2.0)
    (b / "workloads" / "mig-pod64.trickle.json").write_text(json.dumps(cell))
    (b / "metrics" / "rounds_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['h'].counters['rounds'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "mig-pod64.trickle", "config": "mig-pod64",
                               "traffic": "trickle", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "rounds_seen", "unit": "count",
                               "better": "higher", "source": "program_counter",
                               "layer": "event loop", "moves": "round_ms",
                               "workloads": ["mig-pod64.trickle"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mig-pod64.stream" in m.get("workloads", ()):
            m["workloads"].append("mig-pod64.trickle")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items()
               if k.name != "BENCHMARK.json")

    code = ("import json, sys\n"
            "from bench import run\n"
            "r, h = run.measure(['--workload', 'mig-pod64.trickle', '--seed', "
            "'5', '--seconds', '0.5', '--trace', '1'], device='cpu')\n"
            "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert result["metrics"]["rounds_seen"]["value"] > 0
    assert "event_loop_pct" in result["metrics"]


def test_new_configuration_and_cell_pass_the_suite(tmp_path):
    """A cell of a configuration the benchmark lacks: its configuration,
    cell and CPU size files and its entries in BENCHMARK.json, nothing else.
    The copy's own per-cell tests collect it and pass."""
    _copy(tmp_path)
    before = _digests(tmp_path)
    b = tmp_path / "bench"
    conf, cell = "mig-pod64-twin", "mig-pod64-twin.stream"
    shutil.copy(b / "configs" / "mig-pod64.json", b / "configs" / f"{conf}.json")
    work = json.loads((b / "workloads" / "mig-pod64.stream.json").read_text())
    work.update(name=cell, config=conf)
    (b / "workloads" / f"{cell}.json").write_text(json.dumps(work))
    shutil.copy(b / "tests" / "sizes" / "mig-pod64.stream.json",
                b / "tests" / "sizes" / f"{cell}.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    old = next(c for c in bench["configs"] if c["name"] == "mig-pod64")
    bench["configs"].append(dict(old, name=conf,
                                 file=f"bench/configs/{conf}.json"))
    bench["workloads"].append({"name": cell, "config": conf,
                               "traffic": "stream", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mig-pod64.stream" in m.get("workloads", ()):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items()
               if k.name != "BENCHMARK.json")

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         "-p", "no:xdist", "bench/tests/test_bench_cells.py", "-k",
         f"{cell} or every_cell"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    passed = {line.split()[1] for line in out.stdout.splitlines()
              if line.startswith("PASSED ")}
    where = "bench/tests/test_bench_cells.py::"
    assert passed == {where + "test_every_cell_has_a_small_size",
                      where + f"test_cell_runs_and_is_correct[{cell}]",
                      where + f"test_traced_run_reports_per_layer_metrics[{cell}]"}


def test_run_fails_without_the_program(tmp_path):
    _copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "mig-pod64.stream", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
