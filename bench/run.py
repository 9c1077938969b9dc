"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's driver, lets it set up (weights and inputs from the seed,
every shape warmed up), measure for ``--seconds`` and check what its timed
path produced against the plain reference, then prints each number it
compared beside its limit on standard error and, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``.  Exits non-zero, printing no result, without a CUDA card, or if
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
for _p in (_ROOT / "src", _ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def run_environment() -> None:
    """Set before torch and numpy load.  A library that can load JAX by
    itself is kept from doing so; each math library gets one host thread:
    the measured loops are Python on one core, and idle pool threads that
    spin between calls take cycles from it."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that apply to ``cell``."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def measure(argv=None, *, device: str = "cuda", overrides=None,
            t_process: float = None):
    """One run: ``(result dict, checks)``; raises SystemExit without the
    card a cuda run needs.  ``device="cpu"`` runs the program's plain
    versions on the host (the tests use it)."""
    import torch

    from bench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.benchmark()
    entry = {c["name"]: c for c in bench["workloads"]}.get(args.workload)
    if entry is None:
        raise SystemExit(f"unknown workload {args.workload!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < entry["chips"]:
            raise SystemExit(f"{args.workload} needs {entry['chips']} cards, "
                             f"{torch.cuda.device_count()} visible")
    h = harness.Harness(cell=args.workload, seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace),
                        device=device, overrides=overrides,
                        t_process=T_PROCESS if t_process is None else t_process)
    out = harness.driver(h.cell["driver"]).run(h)

    metrics = {}
    if not args.trace:
        values = dict(out["e2e"], setup_s=h.setup_s)
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    else:
        ctx = {"h": h, "out": out, "trace": h.trace_data}
        for m in cell_metrics(bench, args.workload, "per_layer"):
            v = harness.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                            else "cpu"),
                   "count": entry["chips"],
                   "memory_peak_bytes": h.memory_peak_bytes}
    checks = out["checks"]
    result = {"correct": bool(out["failed"] == 0 and all(
                  c["value"] <= c["limit"] for c in checks.values())),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": metrics,
              "device": device_info}
    if args.trace and h.trace_data is not None:
        device_info["busy_s"] = h.trace_data.busy_s
        device_info["window_s"] = h.trace_data.window_s
        result["breakdown"] = h.trace_data.breakdown()
    result["checks"] = checks
    return result, h


def main(argv=None) -> int:
    run_environment()
    from bench import harness

    result, h = measure(argv)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    if h.device == "cuda":
        print(f"card: {harness.card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
