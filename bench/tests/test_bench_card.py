"""On the card: one run of each cell through ``bench/run.py``, as long as
the benchmark's runs, prints a correct result line (skips without a CUDA
card).  A shorter window finishes no chat32 request that it sent: its
outputs are 64-256 tokens at some 40 ms a step."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
SECONDS = harness.benchmark()["run_seconds"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 99), "--seconds", str(SECONDS)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["kind"] == card
