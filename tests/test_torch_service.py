"""The streaming auction service: the port's ``service`` against ``repro``.

The same seeded arrival processes, admission policies and fault hooks
drive ``repro.service.JasdaService`` and its port on the CPU; the award
log and ``ServiceStats`` must be byte-identical.  Host ``"numpy"``
scoring on both sides, and once with the device backends forced on the
64-slice cluster (pools of 800+ bids): the reference's jnp oracle
(``"ref"``) against the port's plain torch versions.  Crash-restart
through the ported ``CheckpointStore`` must replay the uncrashed soak,
and the serving adapter and the launcher must agree with the reference's.
"""
import dataclasses
import json
import pickle
import types

import numpy as np
import pytest

import repro.checkpoint as ref_checkpoint
import repro.core as ref_core
import repro.core.scheduler as ref_scheduler
import repro.launch.serve_auction as ref_launch
import repro.runtime.monitor as ref_monitor
import repro.service as ref_service
import repro.serving as ref_serving
import repro_torch.checkpoint as port_checkpoint
import repro_torch.core as port_core
import repro_torch.core.scheduler as port_scheduler
import repro_torch.launch.serve_auction as port_launch
import repro_torch.runtime.monitor as port_monitor
import repro_torch.service as port_service
import repro_torch.serving as port_serving

GB = 1 << 30
# capacity of the 7-slice cluster is ~12 chips; log-uniform work on
# (8, 40) has mean ~19.9, so this rate offers ~1.0x load
RATE_1X = 12.0 / 19.88
MIG_PROFILES = (("3g.40gb", 40, 3), ("2g.20gb", 20, 2),
                ("1g.10gb-a", 10, 1), ("1g.10gb-b", 10, 1))

REF = types.SimpleNamespace(
    core=ref_core, service=ref_service, serving=ref_serving,
    checkpoint=ref_checkpoint, monitor=ref_monitor, device={},
    SchedulerConfig=ref_scheduler.SchedulerConfig, launch=ref_launch)
PORT = types.SimpleNamespace(
    core=port_core, service=port_service, serving=port_serving,
    checkpoint=port_checkpoint, monitor=port_monitor, device={"device": "cpu"},
    SchedulerConfig=port_scheduler.SchedulerConfig, launch=port_launch)


def _cluster(S):
    return ([S("s20", 20 * GB, n_chips=4), S("s10a", 10 * GB, n_chips=2),
             S("s10b", 10 * GB, n_chips=2)]
            + [S(f"s5{i}", 5 * GB, n_chips=1) for i in range(4)])


def _mig_cluster(S):
    """16 H100s, each MIG-split 3g.40gb + 2g.20gb + 2 x 1g.10gb."""
    return [S(f"gpu{g:02d}-{name}", cap * GB, n_chips=units)
            for g in range(16) for name, cap, units in MIG_PROFILES]


def _sched(ns, cluster=_cluster, **kw):
    return ns.core.JasdaScheduler(cluster(ns.core.SliceSpec),
                                  ns.SchedulerConfig(**kw, **ns.device))


def _poisson(ns, rate=0.5, seed=0, qos_fraction=0.3, deadline_slack=(3.0, 8.0),
             cancel_fraction=0.0, mem_range_gb=(1.0, 12.0)):
    return ns.service.PoissonArrivals(
        rate, seed=seed, work_range=(8.0, 40.0), mem_range_gb=mem_range_gb,
        qos_fraction=qos_fraction, deadline_slack=deadline_slack,
        cancel_fraction=cancel_fraction)


def _service(ns, arrivals=None, admission=None, sched=None, **cfg):
    cfg.setdefault("t_end", 120.0)
    cfg.setdefault("seed", 0)
    return ns.service.JasdaService(
        sched if sched is not None else _sched(ns),
        arrivals if arrivals is not None else _poisson(ns),
        config=ns.service.ServiceConfig(**cfg),
        admission=admission or ns.service.AcceptAll())


def _soak_key(svc, stats):
    """Everything two soaks must agree on, byte for byte (NaN included)."""
    return ([(r.round, r.t, r.variant_id, r.job_id, r.slice_id)
             for r in svc.award_log], json.dumps(dataclasses.asdict(stats)))


def _both(build, **run_kw):
    out = []
    for ns in (REF, PORT):
        svc = build(ns)
        out.append(_soak_key(svc, svc.run(**run_kw)))
    return out


# ---------------------------------------------------------------------------
# arrivals and quantiles
# ---------------------------------------------------------------------------

def _event_key(ev):
    spec = getattr(ev, "spec", None)
    if spec is None:
        return (type(ev).__name__, ev.t, ev.job_id)
    return (type(ev).__name__, ev.t, spec.job_id, spec.arrival_time,
            spec.total_work, spec.qos_deadline, spec.min_capacity,
            repr(spec.fmp))


@pytest.mark.parametrize("mk", [
    lambda ns: ns.service.PoissonArrivals(0.8, seed=0, qos_fraction=0.5,
                                          cancel_fraction=0.2),
    lambda ns: ns.service.BurstArrivals(0.3, 2.0, seed=0, qos_fraction=1.0),
    lambda ns: ns.service.DiurnalArrivals(1.0, period=120.0, seed=0),
], ids=["poisson", "burst", "diurnal"])
def test_arrival_streams_match_reference(mk):
    ref, port = mk(REF), mk(PORT)
    want = [_event_key(e) for e in ref.take_until(200.0)]
    got = []
    for t in np.arange(2.0, 202.0, 2.0):  # cut points must not matter
        got.extend(_event_key(e) for e in port.take_until(float(t)))
    assert got == want and len(want) > 20
    # a pickled stream resumes mid-draw, as the reference's does
    port2 = pickle.loads(pickle.dumps(port))
    assert ([_event_key(e) for e in port2.take_until(300.0)]
            == [_event_key(e) for e in ref.take_until(300.0)])


@pytest.mark.parametrize("dist", ["uniform", "lognormal", "exponential"])
def test_p2_quantiles_match_reference(dist):
    xs = getattr(np.random.default_rng(0), dist)(size=2000)
    for q in (0.5, 0.95, 0.99):
        a, b = REF.service.P2Quantile(q), PORT.service.P2Quantile(q)
        for x in xs:
            a.observe(x)
            b.observe(x)
        assert a.value() == b.value()


def test_admission_helpers_match_reference():
    for m in (16, 128, 512, 32768):
        assert (PORT.service.queue_bound_for_bucket(m)
                == REF.service.queue_bound_for_bucket(m))
    got = []
    for ns in (REF, PORT):
        tb = ns.service.TokenBucket(rate=0.1, burst=2.0)
        got.append([tb.on_arrival(None, float(t), [])[0]
                    for t in range(0, 40, 2)])
    assert got[1] == got[0] and got[0][:2] == [True, True] and not all(got[0])


# ---------------------------------------------------------------------------
# soaks: byte-identical to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", [True, False])
def test_soak_matches_reference(pipeline):
    ref, port = _both(lambda ns: _service(
        ns, _poisson(ns, cancel_fraction=0.05), pipeline=pipeline))
    assert ref[0] and port == ref


@pytest.mark.parametrize("admission", ["accept-all", "bounded", "token-bucket"])
def test_admission_policies_match_reference(admission):
    def build(ns):
        pol = {"accept-all": ns.service.AcceptAll(),
               "bounded": ns.service.BoundedQueue(),
               "token-bucket": ns.service.TokenBucket(0.5, burst=4.0)}
        return _service(ns, _poisson(ns, rate=2 * RATE_1X, qos_fraction=1.0,
                                     deadline_slack=(1.0, 2.0)),
                        admission=pol[admission], t_end=100.0,
                        max_bucket_m=128)

    ref, port = _both(build)
    assert port == ref
    stats = json.loads(ref[1])
    assert stats["n_expired"] > 0
    assert (stats["n_shed"] > 0) == (admission != "accept-all")


@pytest.mark.parametrize("kind", ["burst", "diurnal"])
def test_burst_and_diurnal_soaks_match_reference(kind):
    def build(ns):
        kw = dict(seed=0, work_range=(8.0, 40.0), mem_range_gb=(1.0, 12.0),
                  qos_fraction=0.3, deadline_slack=(2.0, 6.0))
        arr = (ns.service.BurstArrivals(0.3, 1.5, **kw) if kind == "burst"
               else ns.service.DiurnalArrivals(0.9, period=60.0, **kw))
        return _service(ns, arr, t_end=120.0)

    ref, port = _both(build)
    assert ref[0] and port == ref


def test_muted_slice_revoked_as_reference():
    def build(ns):
        svc = _service(ns, _poisson(ns, rate=0.8), t_end=80.0)
        svc.mute_slice("s20")
        return svc

    ref, port = _both(build)
    assert port == ref
    assert json.loads(ref[1])["n_revoked_slices"] == 1


def test_straggler_degraded_as_reference():
    def build(ns):
        monitor = ns.monitor.HealthMonitor(ns.monitor.HealthConfig(
            heartbeat_interval=1.0, straggler_ratio=0.6, speed_halflife=2))
        svc = ns.service.JasdaService(
            _sched(ns), _poisson(ns, rate=0.8, qos_fraction=0.0),
            config=ns.service.ServiceConfig(t_end=100.0, seed=0),
            monitor=monitor)
        orig = svc.exec.launch

        def slow_launch(v, t_now):
            orig(v, t_now)
            if v.slice_id == "s10a" and "s10a" in svc.exec.running:
                vv, end = svc.exec.running["s10a"]
                svc.exec.running["s10a"] = (
                    vv, vv.t_start + 3.0 * (end - vv.t_start))

        svc.exec.launch = slow_launch
        return svc

    ref, port = _both(build)
    assert port == ref
    assert json.loads(ref[1])["n_degraded_slices"] >= 1


def test_migration_ladder_in_service_matches_reference():
    def build(ns):
        svc = _service(ns, _poisson(ns, rate=0.6, mem_range_gb=(1.0, 8.0)),
                       t_end=80.0, migration=True)
        svc.mute_slice("s10a")
        return svc

    ref, port = _both(build)
    assert port == ref
    assert json.loads(ref[1])["n_revoked_slices"] == 1


def test_device_backends_on_64_slice_cluster_match_reference():
    """Rate 2 on the 64-slice MIG cluster: pools pass 256 bids, so both
    sides take their device paths (jnp oracle; the port's plain torch
    versions, and its "cuda" backends, which run the same on the CPU)."""
    def build(ns, impl, pipeline=True):
        sched = _sched(ns, _mig_cluster, score_impl=impl, wis_impl=impl)
        arr = ns.service.PoissonArrivals(
            2.0, seed=0, work_range=(8.0, 40.0), qos_fraction=0.3,
            deadline_slack=(2.0, 6.0))
        return _service(ns, arr, sched=sched, t_end=60.0, max_bucket_m=32768,
                        pipeline=pipeline)

    runs = {}
    for tag, ns, impl, pipeline in (("ref", REF, "ref", True),
                                    ("torch", PORT, "torch", True),
                                    ("cuda serial", PORT, "cuda", False)):
        svc = build(ns, impl, pipeline)
        runs[tag] = _soak_key(svc, svc.run())
        bids = [r.n_bids for r in svc.scheduler.log if r.n_windows]
        assert max(bids) >= 800 and sum(b >= 256 for b in bids) >= 20
        if ns is PORT:
            assert svc.scheduler.backend_health.failed_backends() == {}
    assert runs["torch"] == runs["ref"] == runs["cuda serial"]


# ---------------------------------------------------------------------------
# durability through the ported store
# ---------------------------------------------------------------------------

def test_second_run_call_continues_the_rounds():
    """``run(t)`` leaves the first event past ``t`` queued, and a round tick
    is queued past the horizon too, so a second ``run`` call goes on where
    the first stopped: the port's soak in two calls equals one soak.  The
    reference pops that event and drops it, and queues no tick past the
    horizon: its second call runs no round (ROADMAP, Divergences)."""
    got = {}
    for ns in (REF, PORT):
        whole = _service(ns)
        one = _soak_key(whole, whole.run(t_end=60.0))
        split = _service(ns)
        split.run(t_end=30.0)
        two = _soak_key(split, split.run(t_end=60.0))
        got[ns is PORT] = (one, two, whole.round_count, split.round_count)
    ref_one, ref_two, ref_whole, ref_split = got[False]
    assert ref_whole == 61 and ref_split == 31 and ref_two != ref_one
    port_one, port_two, port_whole, port_split = got[True]
    assert port_one == ref_one
    assert port_two == port_one and port_split == port_whole == 61


def test_crash_restart_replays_reference_soak(tmp_path):
    store = PORT.checkpoint.CheckpointStore(str(tmp_path), keep=10)
    svc = _service(PORT, _poisson(PORT, cancel_fraction=0.05))
    whole = _soak_key(svc, svc.run(checkpoint=store, checkpoint_every=30))
    steps = store.steps()
    assert len(steps) >= 3
    mid = steps[len(steps) // 2]
    resumed = PORT.service.JasdaService.restore(store, mid)
    assert resumed.round_count == mid
    ref_svc = _service(REF, _poisson(REF, cancel_fraction=0.05))
    want = _soak_key(ref_svc, ref_svc.run())
    assert _soak_key(resumed, resumed.run()) == whole == want


def test_restore_latest_and_foreign_payload(tmp_path):
    store = PORT.checkpoint.CheckpointStore(str(tmp_path), keep=10)
    svc = _service(PORT, t_end=60.0)
    svc.run(checkpoint=store, checkpoint_every=20)
    assert PORT.service.JasdaService.restore(store).round_count == max(store.steps())
    other = PORT.checkpoint.CheckpointStore(str(tmp_path / "other"))
    other.save_state(0, {"not": "a service"})
    with pytest.raises(TypeError):
        PORT.service.JasdaService.restore(other)


def test_save_restore_save_keeps_index_monotone(tmp_path):
    steps = {}
    for ns in (REF, PORT):
        store = ns.checkpoint.CheckpointStore(str(tmp_path / str(id(ns))),
                                              keep=10)
        svc = _service(ns, t_end=40.0)
        svc.run(checkpoint=store, checkpoint_every=10)
        first = list(store.steps())
        svc2 = ns.service.JasdaService.restore(store, first[0])
        st = svc2.run(t_end=80.0, checkpoint=store, checkpoint_every=10)
        steps[ns is PORT] = (first, store.steps(), store.latest_step(),
                             _soak_key(svc2, st))
    assert steps[True] == steps[False]


def test_device_soak_snapshot_restores_on_its_device(tmp_path):
    """A service pickled mid-stream with the device backends (scoring
    state, settle selector, the scheduler's device) resumes identically."""
    def build():
        sched = _sched(PORT, _mig_cluster, score_impl="torch", wis_impl="torch")
        arr = PORT.service.PoissonArrivals(
            2.0, seed=0, work_range=(8.0, 40.0), qos_fraction=0.3,
            deadline_slack=(2.0, 6.0))
        return _service(PORT, arr, sched=sched, t_end=40.0, max_bucket_m=32768)

    store = PORT.checkpoint.CheckpointStore(str(tmp_path), keep=10)
    svc = build()
    whole = _soak_key(svc, svc.run(checkpoint=store, checkpoint_every=15))
    resumed = PORT.service.JasdaService.restore(store, 30)
    assert resumed.scheduler.device == svc.scheduler.device
    assert _soak_key(resumed, resumed.run()) == whole


# ---------------------------------------------------------------------------
# the serving adapter and the launcher
# ---------------------------------------------------------------------------

def _trace(ns, n=6):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        prompt = rng.integers(0, 100, size=8 + 2 * i).astype(np.int32)
        out.append((1.0 + 2.0 * i,
                    ns.serving.Request(f"r{i}", prompt, max_new_tokens=8 + i)))
    return out


def test_serving_adapter_matches_reference():
    for factor in (None, 4.0):
        specs = [[_event_key(e) for e in ns.serving.ServingArrivals(
            _trace(ns), deadline_factor=factor).take_until(float("inf"))]
            for ns in (REF, PORT)]
        assert specs[0] == specs[1] and specs[0]
    req = _trace(PORT, 1)[0][1]
    ref_req = _trace(REF, 1)[0][1]
    assert (repr(PORT.serving.request_job_spec(req, 3.0, deadline_factor=2.0))
            == repr(REF.serving.request_job_spec(ref_req, 3.0,
                                                 deadline_factor=2.0)))
    ref, port = _both(lambda ns: _service(
        ns, ns.serving.ServingArrivals(_trace(ns)), t_end=90.0))
    assert port == ref
    assert json.loads(ref[1])["n_completed"] == 6


@pytest.mark.parametrize("argv", [
    ["--json", "--t-end", "60"],
    ["--json", "--t-end", "80", "--arrivals", "burst", "--admission",
     "bounded", "--no-pipeline"],
], ids=["poisson", "burst-bounded-serial"])
def test_launcher_prints_the_reference_line(argv, capsys):
    assert REF.launch.main(argv) == 0
    want = capsys.readouterr().out
    assert PORT.launch.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want


def test_launcher_resumes_from_checkpoint(tmp_path, capsys):
    base = ["--json", "--t-end", "60", "--device", "cpu"]
    assert PORT.launch.main(base) == 0
    whole = capsys.readouterr().out
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "20"]
    assert PORT.launch.main(base + ck) == 0
    assert capsys.readouterr().out == whole
    assert PORT.launch.main(base + ck + ["--resume"]) == 0
    assert capsys.readouterr().out == whole
