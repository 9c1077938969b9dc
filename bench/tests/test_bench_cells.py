"""Each cell runs on the CPU through the program's plain versions, at a
size cut to seconds, and its result line meets the benchmark's contract:
the reference agrees with the program there."""
import json
import math

import pytest

from bench import harness, run
from bench.tests.small import SMALL, run_small

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def contract_errors(result: dict, cell: str, trace: int) -> list:
    errs = []
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        if key not in result:
            errs.append(f"missing {key}")
    if list(result)[-1] != "checks":
        errs.append("checks is not the last key")
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in run.cell_metrics(BENCH, cell, kind)}
    for name, m in result["metrics"].items():
        if want.get(name) != m["unit"] or not math.isfinite(m["value"]):
            errs.append(f"metric {name}: {m}")
    if not trace and set(result["metrics"]) != set(want):
        errs.append(f"end-to-end metrics {sorted(result['metrics'])}")
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        if key not in result["device"]:
            errs.append(f"device lacks {key}")
    for name, c in result["checks"].items():
        if set(c) != {"value", "limit"}:
            errs.append(f"check {name}: {c}")
    json.dumps(result)
    return errs


def test_every_cell_has_a_small_size():
    """Each cell has its file ``sizes/<cell>.json``, and no file is left
    without a cell."""
    assert set(SMALL) == set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    result, h = run_small(cell, seed=2**31 + 17)
    assert contract_errors(result, cell, 0) == []
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(cell):
    result, h = run_small(cell, seed=2**31 + 18, trace=1)
    assert contract_errors(result, cell, 1) == []
    assert result["correct"], result["checks"]
    # the readers that need no device trace find something on the CPU
    assert result["metrics"]


def test_chat_checks_only_the_window_requests():
    result, h = run_small("falcon-mamba-7b.chat32", seed=2**31 + 19)
    assert result["correct"], result["checks"]
    window = h.window_requests
    assert window and result["attempted"] == len(window)
    assert all(h.t_open <= r.t_submit and r.t_done <= h.t_close
               for r in window)
    sent = {(tuple(r.prompt), tuple(r.output)) for r in window}
    _, rows, _ = h.reference
    assert rows and all((tuple(p), tuple(o)) in sent for p, o in rows)
    # the window closes on a count of steps: the check is full on any host
    assert h.counters["steps"] == h.params["window_steps"]
    assert len(rows) == h.params["check_requests"]
