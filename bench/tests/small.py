"""Each cell cut to a size the CPU runs in seconds, and a helper that runs a
cell on the CPU.

A cell's size is a file of its own, ``sizes/<cell>.json``: ``params``, the
overrides of the cell's parameters, and ``why``.  A new cell brings its file.
"""
import json
from pathlib import Path

from bench import run

SIZES = Path(__file__).resolve().with_name("sizes")
#: cell -> the overrides of its parameters
SMALL = {p.name[:-len(".json")]: json.loads(p.read_text())["params"]
         for p in sorted(SIZES.glob("*.json"))}


def run_small(cell: str, seed: int, seconds: float = 1.0, trace: int = 0,
              **more):
    """``(result line, harness)`` of one run of ``cell`` on the CPU."""
    over = dict(SMALL[cell], **more)
    return run.measure(["--workload", cell, "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(trace)],
                       device="cpu", overrides=over)
