"""The slice as a whole: seeded simulations through both packages.

The ``_run_sched`` workload of ``tests/test_device_settle.py`` runs through
``repro`` with its device backends forced to the jnp reference and through
the port with its torch backends on the CPU, pipelined and serial.  The
commit logs match exactly in (variant_id, slice_id, t_start), scores
within 3e-5 (float32 scores from two libraries), and the summaries are
equal strings.  On the CPU the "cuda" backends run the plain versions, so
they must give the torch run's log bit for bit -- also after an injected
dispatch fault walks the degradation ladder.
"""
import numpy as np
import pytest

from repro.core import JasdaScheduler as RefScheduler
from repro.core import Policy as RefPolicy
from repro.core import SimConfig as RefSimConfig
from repro.core import SliceSpec as RefSliceSpec
from repro.core import make_workload as ref_make_workload
from repro.core import simulate as ref_simulate
from repro.core.scheduler import SchedulerConfig as RefSchedulerConfig
from repro_torch import convert
from repro_torch.core import (FaultEvent, FaultPlan, JasdaScheduler, Policy,
                              SimConfig, SliceSpec, make_workload, simulate)
from repro_torch.core.faults import DEVICE_DISPATCH_FAIL
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.kernels.common import clear_dispatch_faults

GB = 1 << 30
SCORE_ATOL = 3e-5


def _slices(spec_cls):
    return [spec_cls("s20", 20 * GB, n_chips=4),
            spec_cls("s10", 10 * GB, n_chips=2),
            spec_cls("s5", 5 * GB, n_chips=1)]


def _digest(sched, res):
    return (
        [(r.t, r.n_selected) for r in sched.log],
        [(c.variant_id, c.slice_id, c.t_start) for c in sched.commit_log],
        np.array([c.score for c in sched.commit_log]),
        res.summary(),
    )


#: reference presets: GreedyWIS, GlobalAssignment (best-fit windows) and
#: FairShare (its selection transform rides the fused first pass)
PRESETS = {"balanced": RefPolicy, "utilization": RefPolicy.utilization,
           "fairness": RefPolicy.fairness}


def _run_ref(pipeline, preset="balanced"):
    cfg = RefSchedulerConfig.from_policy(PRESETS[preset](), wis_impl="ref",
                                         score_impl="ref")
    sched = RefScheduler(_slices(RefSliceSpec), cfg)
    res = ref_simulate(sched, ref_make_workload(40, seed=3, arrival_rate=0.3),
                       RefSimConfig(t_end=900.0, seed=2, pipeline=pipeline))
    return _digest(sched, res)


def _run_port(pipeline, impl="torch", faults=None, policy=None):
    pol = policy if policy is not None else Policy()
    cfg = SchedulerConfig.from_policy(pol, wis_impl=impl, score_impl=impl,
                                      device="cpu")
    sched = JasdaScheduler(_slices(SliceSpec), cfg)
    res = simulate(sched, make_workload(40, seed=3, arrival_rate=0.3),
                   SimConfig(t_end=900.0, seed=2, pipeline=pipeline),
                   faults=faults)
    return _digest(sched, res), sched


def _assert_same(port, ref):
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert len(port[1]) > 20  # the run actually committed work
    np.testing.assert_allclose(port[2], ref[2], atol=SCORE_ATOL, rtol=0)
    assert port[3] == ref[3]


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("pipeline", [True, False])
def test_round_matches_reference(pipeline, preset):
    port, sched = _run_port(pipeline,
                            policy=convert.policy(PRESETS[preset]()))
    _assert_same(port, _run_ref(pipeline, preset))
    assert sched.backend_health.failed_backends() == {}


def test_cuda_backends_on_cpu_equal_torch():
    torch_run, _ = _run_port(True, impl="torch")
    cuda_run, sched = _run_port(True, impl="cuda")
    assert cuda_run[:2] == torch_run[:2] and cuda_run[3] == torch_run[3]
    np.testing.assert_array_equal(cuda_run[2], torch_run[2])
    assert sched.backend_health.failed_backends() == {}


def test_injected_fault_walks_ladder():
    """An injected cuda dispatch fault steps the round down to torch (sticky)
    and changes no commit."""
    plan = FaultPlan(events=(FaultEvent(100.0, DEVICE_DISPATCH_FAIL, "cuda"),))
    try:
        faulted, sched = _run_port(False, impl="cuda", faults=plan)
    finally:
        clear_dispatch_faults()
    assert set(sched.backend_health.failed_backends()) == {"cuda"}
    clean, _ = _run_port(False, impl="torch")
    assert faulted[:2] == clean[:2] and faulted[3] == clean[3]
    np.testing.assert_array_equal(faulted[2], clean[2])


@pytest.mark.parametrize("backend,failed", [("ref", "torch"),
                                            ("pallas", "cuda")])
def test_reference_fault_plan_lands_on_port_backend(backend, failed):
    """A FaultPlan written for the reference names its backends ("ref",
    "pallas"); the port's simulator lands them on its torch / cuda twins."""
    plan = FaultPlan.generate(3, t_end=900.0, dispatch_fail_times=[100.0],
                              backend=backend)
    try:
        _, sched = _run_port(False, impl=failed, faults=plan)
    finally:
        clear_dispatch_faults()
    assert set(sched.backend_health.failed_backends()) == {failed}


def test_converted_policy_runs_identically():
    """A reference Policy carried over by ``convert`` drives the port to the
    same commits as the port's own Policy."""
    ref_pol = RefPolicy.fairness()
    port_pol = convert.policy(ref_pol)
    assert port_pol == Policy.fairness()
    a, _ = _run_port(True, policy=port_pol)
    b, _ = _run_port(True, policy=Policy.fairness())
    assert a[:2] == b[:2] and a[3] == b[3]


def test_calibrator_carried_over():
    from repro.core.calibration import Calibrator as RefCalibrator

    ref = RefCalibrator()
    ref.state("J0").hist_avg = 0.8
    ref.state("J0").n_verified = 3
    port = convert.calibrator(ref)
    assert port.snapshot() == ref.snapshot()
    assert convert.calibrator(ref.snapshot()).snapshot() == ref.snapshot()


def test_mesh_refused():
    """A mesh the scheduler cannot run on is refused at construction: an
    object that is not a ``launch.mesh.Mesh``, and a mesh whose devices are
    not of the configured device's type.  (A matching mesh is accepted:
    ``tests/test_torch_sharded_auction.py``.)"""
    from repro_torch.launch.mesh import make_auction_mesh

    cfg = SchedulerConfig.from_policy(Policy(), device="cpu", mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        JasdaScheduler(_slices(SliceSpec), cfg)
    cpu_mesh = make_auction_mesh(4, devices=["cpu"] * 4)
    cfg = SchedulerConfig.from_policy(Policy(), device="cuda", mesh=cpu_mesh)
    with pytest.raises(ValueError, match="mesh"):
        JasdaScheduler(_slices(SliceSpec), cfg)


@pytest.mark.parametrize("layer", ["repartition", "migration"])
def test_unported_sim_layers_refuse(layer):
    """The simulator layers that once refused to run (repartition,
    migration) are ported: they run and give the reference's result."""
    from repro.core import MigrationConfig as RefMigrationConfig
    from repro.core import StaticInventory as RefStaticInventory
    from repro_torch.core import MigrationConfig, StaticInventory

    port_layer, ref_layer = {
        "repartition": (StaticInventory(), RefStaticInventory()),
        "migration": (MigrationConfig(), RefMigrationConfig())}[layer]
    cfg = SchedulerConfig.from_policy(Policy(), device="cpu")
    sched = JasdaScheduler(_slices(SliceSpec), cfg)
    res = simulate(sched, make_workload(3, seed=0),
                   SimConfig(t_end=5.0, **{layer: port_layer}))
    ref = ref_simulate(RefScheduler(_slices(RefSliceSpec), RefPolicy()),
                       ref_make_workload(3, seed=0),
                       RefSimConfig(t_end=5.0, **{layer: ref_layer}))
    assert res.summary() == ref.summary()
