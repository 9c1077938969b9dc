"""On the card: one short run of each cell through ``bench/run.py`` prints
a correct result line (skips without a CUDA card)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 99), "--seconds", "3"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["kind"] == card
