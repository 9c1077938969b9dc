"""The port's mirror of ``tests/test_system.py``: the same tests on the same
inputs through ``repro_torch``, its backends mapped ("ref" -> "torch",
"pallas" -> "cuda", ``trace_counts`` -> ``build_counts``) and run on the
host through the port's own ``device="cpu"`` arguments.  Below, the
reference file's own description.

End-to-end system behaviour: the paper's full loop + framework glue."""
import numpy as np
import pytest

from repro_torch.core import (SimConfig, SliceSpec, make_workload, simulate)


# -- the port on the host: its "torch" / "cuda" backends run on the CPU only
# when asked, so every scheduler and round entry point gets device="cpu"
import dataclasses as _dc  # noqa: E402

import repro_torch.core as _port_core  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig as _Config  # noqa: E402


def on_cpu(config=None):
    """``config`` (None, a ``Policy`` or a ``SchedulerConfig``) with the
    device backends on the host."""
    if config is None:
        return _Config(device="cpu")
    if isinstance(config, _port_core.Policy):
        return _Config.from_policy(config, device="cpu")
    return _dc.replace(config, device="cpu")


def JasdaScheduler(slices, config=None):
    return _port_core.JasdaScheduler(slices, on_cpu(config))


GB = 1 << 30


def test_full_interaction_cycle_end_to_end():
    """One complete JASDA lifecycle: announce → bid → clear → commit →
    execute → verify, with metrics coming out the other side."""
    slices = [SliceSpec(f"s{k}", 20 * GB, n_chips=2) for k in range(3)]
    sched = JasdaScheduler(slices)
    agents = make_workload(25, seed=9, arrival_rate=0.5)
    res = simulate(sched, agents, SimConfig(t_end=2500.0, seed=1))
    assert res.n_finished == 25
    assert res.capacity_violations <= 2
    assert res.utilization > 0.1
    # audit trail exists (transparency, paper §5(f))
    assert len(sched.log) > 100
    assert any(row.n_selected > 0 for row in sched.log)
    # ex-post verification ran: every job has calibration state
    snap = sched.calibrator.snapshot()
    assert len(snap) == 25
    assert all(0 < s["rho"] <= 1 for s in snap.values())


def test_lambda_policy_spectrum():
    """Table 2's qualitative claim: the λ knob changes scheduling behaviour
    (selection order shifts between job-centric and system-centric)."""
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.core import ScoringPolicy
    slices = [SliceSpec("s0", 16 * GB, n_chips=2)]
    orders = {}
    for lam in (0.3, 0.7):
        sched = JasdaScheduler(
            [SliceSpec("s0", 16 * GB, n_chips=2)],
            SchedulerConfig(scoring=ScoringPolicy(lam=lam)))
        agents = make_workload(30, seed=4, arrival_rate=2.0)
        simulate(sched, agents, SimConfig(t_end=1000.0, seed=2))
        # commit_log is the append-only audit trail; `commitments` holds only
        # OUTSTANDING commitments (settled ones are pruned)
        orders[lam] = tuple(r.job_id for r in sched.commit_log[:20])
    assert orders[0.3] != orders[0.7], "λ must influence clearing decisions"


def test_quickstart_example_runs():
    """``examples/quickstart_torch.py`` on the host prints what the JAX
    package's ``examples/quickstart.py`` prints, line for line, with every
    round scored and cleared by the plain torch versions."""
    import subprocess, sys, os
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "examples/quickstart.py", "--steps", "5"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    out = subprocess.run(
        [sys.executable, "examples/quickstart_torch.py", "--steps", "5",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout == ref.stdout
    assert "finished=5/5" in ref.stdout
