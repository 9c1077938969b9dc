"""Read a cell's numbers on several seeds, the program's and the control's.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed it runs the cell as ``run.py`` does and prints one JSON line:
the numbers the run compared (the program's readings) and the same
numbers with the control in the program's place, as the cell's driver
defines it (``control(h)``): the plain reference computed in the precision
below the one the configuration states.  A cell's limits are set between
the program's readings over a dozen seeds or more and the control's.  The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
for _p in (_ROOT / "src", _ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv=None) -> int:
    from bench import run

    run.run_environment()
    from bench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, h = run.measure(["--workload", args.workload, "--seed",
                                 str(seed), "--seconds", args.seconds],
                                device=args.device, t_process=t0)
        ctl = harness.driver(h.cell["driver"]).control(h)
        print(json.dumps({
            "seed": seed, "correct": result["correct"],
            "program": {k: v["value"] for k, v in result["checks"].items()},
            "control": ctl,
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
