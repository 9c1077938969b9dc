"""Repartitioning and migration: the port's ``core.repartition`` against
``repro``.

The profile lattice, the buddy layout and the fragmentation index give
the reference's results; simulations with a repartition policy
(fragmentation-aware merges, energy-aware gating, a forced drain) or the
migration ladder give the reference's commit log, JCTs and coordinator
counters byte for byte, serial and pipelined, and across a crash restored
through the ported store.  The service repartitions the 64-chip pod of
eight 8-chip slices: splits change the window count between rounds, and
the run equals the reference's on host numpy and, with the device
backends forced (the reference's jnp oracle, the port's plain torch
versions), pipelined and serial.
"""
import dataclasses
import json
import pickle
import types

import numpy as np
import pytest

import repro.checkpoint as ref_checkpoint
import repro.core as ref_core
import repro.core.events as ref_events
import repro.core.scheduler as ref_scheduler
import repro.core.windows as ref_windows
import repro.service as ref_service
import repro_torch.checkpoint as port_checkpoint
import repro_torch.core as port_core
import repro_torch.core.events as port_events
import repro_torch.core.scheduler as port_scheduler
import repro_torch.core.windows as port_windows
import repro_torch.service as port_service
from repro_torch.core.faults import SCHEDULER_CRASH, SLICE_REVOKED

GB = 1 << 30

REF = types.SimpleNamespace(
    core=ref_core, service=ref_service, checkpoint=ref_checkpoint,
    events=ref_events, windows=ref_windows, device={},
    SchedulerConfig=ref_scheduler.SchedulerConfig)
PORT = types.SimpleNamespace(
    core=port_core, service=port_service, checkpoint=port_checkpoint,
    events=port_events, windows=port_windows, device={"device": "cpu"},
    SchedulerConfig=port_scheduler.SchedulerConfig)


def _sched(ns, specs, policy=None, **kw):
    cfg = ns.SchedulerConfig(**kw, **ns.device)
    if policy is not None:
        cfg = ns.SchedulerConfig.from_policy(policy, **kw, **ns.device)
    return ns.core.JasdaScheduler(specs(ns.core.SliceSpec), cfg)


def _packed(S, cap_gb=5):
    return [S("big0", 4 * cap_gb * GB, n_chips=4),
            S("big1", 4 * cap_gb * GB, n_chips=4)]


def _fragmented(S, cap_gb=5):
    return [S(f"f{k}", cap_gb * GB, n_chips=1) for k in range(8)]


def _mig_slices(S, n=4, cap_gb=16):
    return [S(f"S{k}", cap_gb * GB, flops_per_s=1.0, hbm_bw=1.0)
            for k in range(n)]


def _pod(S):
    """A 64-chip pod of eight 8-chip 80 GB slices."""
    return [S(f"s{i}", 80 * GB, n_chips=8) for i in range(8)]


def _hetero_workload(ns, n=30, seed=3):
    """~60% of jobs need more than one 5 GB chip."""
    return ns.core.make_workload(n, seed=seed, arrival_rate=0.5,
                                 work_range=(5.0, 40.0), mem_range_gb=(1.0, 4.0),
                                 min_capacity_fraction=0.6,
                                 min_capacity_range_gb=(12.0, 18.0))


def _mig_workload(ns, n=14, granularity=0.0, seed=1):
    return ns.core.make_workload(n, seed=seed, arrival_rate=0.5,
                                 work_range=(20.0, 60.0), mem_range_gb=(1.0, 8.0),
                                 preempt_granularity=granularity)


def _commit_rows(sched):
    return [(r.status, r.job_id, r.slice_id, r.t_start, r.t_end, r.score,
             getattr(r, "work_credited", 0.0)) for r in sched.commit_log]


def _sim_key(r):
    coord = r.repartition.stats() if r.repartition is not None else None
    return (_commit_rows(r.scheduler), r.jct_per_job, r.n_finished,
            r.total_score, r.summary(), coord, sorted(r.scheduler.slices),
            (r.n_migrated, r.n_preempted, r.n_lost_commitments,
             r.work_credited, tuple(r.loss_reasons)))


def _both(run):
    return [run(ns) for ns in (REF, PORT)]


# ---------------------------------------------------------------------------
# lattice, buddy layout, fragmentation index
# ---------------------------------------------------------------------------

def _layout_ops(ns):
    c = ns.core
    out = []
    lat = c.ProfileLattice.default(max_chips=8)
    out.append([(p.n_chips, p.capacity_bytes, p.power_watts, p.idle_watts)
                for p in lat.profiles])
    out.append([(lat.can_split(n), lat.can_merge(n)) for n in (1, 2, 4, 8)])
    inferred = c.ProfileLattice.infer(_fragmented(c.SliceSpec))
    out.append([(p.n_chips, p.capacity_bytes) for p in inferred.profiles])
    tmpl = c.SliceSpec("t", 5 * GB, n_chips=1, flops_per_s=3.0, hbm_bw=2.0)
    out.append(repr(lat.spec_for("p0c2", 2, template=tmpl)))
    for bad in (lambda: c.ProfileLattice.infer(
            [c.SliceSpec("a", 5 * GB), c.SliceSpec("b", 7 * GB)]),
            lambda: c.SliceProfile(n_chips=3, capacity_bytes=GB,
                                   power_watts=1.0)):
        with pytest.raises(ValueError):
            bad()
    # buddy layout: adoption, split/merge cycles, sibling rules
    specs = _fragmented(c.SliceSpec)[:4] + [
        c.SliceSpec("m0", 10 * GB, n_chips=2), c.SliceSpec("m1", 10 * GB, n_chips=2)]
    lat6 = c.ProfileLattice.infer(specs)
    st = c.RepartitionState.adopt(list(reversed(specs)), lat6)
    out.append(sorted(st.intervals.items()))
    out.append(st.mergeable_pairs(lat6))
    out.append(st.mergeable_pairs(lat6, live={s.slice_id for s in specs} - {"m0"}))
    root = c.RepartitionState.adopt([c.SliceSpec("root", 20 * GB, n_chips=4)],
                                    c.ProfileLattice.default(max_chips=4))
    a, b = root.apply_split("root")
    out.append((a, b, root.buddy_of(a[0]), root.apply_merge(a[0], b[0]),
                root.apply_split("p0c4")))
    by_off = {off: sid for sid, (off, _) in st.intervals.items()}
    with pytest.raises(ValueError):
        st.apply_merge(by_off[5], by_off[6])  # adjacent, not buddies
    # fragmentation index, and the frag_aware announcement order
    caps = [5 * GB, 5 * GB]
    out.append([c.fragmentation_index(caps, d) for d in (
        [], [(10.0, 4 * GB)], [(10.0, 8 * GB)], [(30.0, 8 * GB), (10.0, GB)])])
    tl = {s.slice_id: ns.windows.SliceTimeline(s) for s in [
        c.SliceSpec("c20", 20 * GB), c.SliceSpec("c10", 10 * GB),
        c.SliceSpec("c5", 5 * GB)]}
    for kind in ("frag_aware", "earliest", "best_fit", "slack"):
        pol = ns.windows.WindowPolicy(kind=kind, horizon=50.0)
        for demand in (None, [9 * GB]):
            out.append([w.slice_id for w in ns.windows.announce_windows(
                tl, 0.0, pol, demand=demand)])
    em = c.EnergyModel(watts={"lo": 100.0, "hi": 400.0}, peak=400.0)
    out.append([em.psi(s) for s in ("lo", "hi", "unknown")])
    reg = ns.windows.DeadWindowRegistry()
    reg.add("a", 1.0, 10.0)
    reg.add("a", 5.0, 10.0)
    reg.add("b", 1.0, 10.0)
    out.append((reg.drop_slice("a"), reg.suppressed("a", 1.0),
                reg.suppressed("b", 1.0), reg.drop_slice("a")))
    return out


def test_lattice_buddy_and_fragmentation_match_reference():
    ref, port = _both(_layout_ops)
    assert port == ref


# ---------------------------------------------------------------------------
# simulations with a repartition policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", [False, True])
def test_static_inventory_identical_to_no_subsystem(pipeline):
    def run(ns, repartition):
        return _sim_key(ns.core.simulate(
            _sched(ns, _packed), _hetero_workload(ns, 14),
            ns.core.SimConfig(t_end=250.0, seed=0, pipeline=pipeline,
                              repartition=repartition)))

    off = run(PORT, None)
    on = run(PORT, PORT.core.StaticInventory())
    assert off[:5] == on[:5] and on[5]["n_splits"] == on[5]["n_forced"] == 0
    assert on == run(REF, REF.core.StaticInventory())


@pytest.mark.parametrize("pipeline", [False, True])
def test_fragmentation_aware_matches_reference(pipeline):
    def run(ns):
        r = ns.core.simulate(
            _sched(ns, _fragmented), _hetero_workload(ns),
            ns.core.SimConfig(t_end=300.0, seed=0, pipeline=pipeline,
                              repartition=ns.core.FragmentationAware()))
        return _sim_key(r) + (r.repartition.frag_trace,)

    ref, port = _both(run)
    assert port == ref
    assert ref[5]["n_merges"] > 0  # the slice count changed mid-stream


def test_energy_aware_matches_reference():
    def run(ns):
        pol = ns.core.Policy(scoring=ns.core.ScoringPolicy(betas={
            "utilization": 0.2, "slack": 0.1, "mem_headroom": 0.1,
            "age": 0.1, "energy": 0.3}))
        r = ns.core.simulate(
            _sched(ns, _fragmented, policy=pol),
            ns.core.make_workload(6, seed=1, arrival_rate=1.0,
                                  work_range=(5.0, 15.0), mem_range_gb=(1.0, 4.0)),
            ns.core.SimConfig(t_end=400.0, seed=0, repartition=ns.core.EnergyAware(
                gate_after=2, min_active=1)))
        return _sim_key(r)

    ref, port = _both(run)
    assert port == ref
    assert ref[5]["n_gates"] > 0


def test_ungate_under_backlog_matches_reference():
    def run(ns):
        c = ns.core
        sched = _sched(ns, lambda S: _fragmented(S)[:2])
        lat = c.ProfileLattice((c.SliceProfile(
            n_chips=1, capacity_bytes=5 * GB, power_watts=350.0,
            idle_watts=52.5),))
        coord = c.RepartitionCoordinator(
            sched, c.EnergyAware(gate_after=1, min_active=1,
                                 ungate_backlog=10.0), lattice=lat)
        seen = []
        for t in (0.0, 1.0):
            coord.tick(t)
            seen.append((sorted(sched.slices), dict(coord.state.gated)))
        for a in c.make_workload(12, seed=0, work_range=(50.0, 80.0),
                                 mem_range_gb=(1.0, 3.0)):
            sched.add_job(a, 2.0)
        coord.tick(2.0)
        seen.append((sorted(sched.slices), coord.stats()))
        return repr(seen)

    ref, port = _both(run)
    assert port == ref


def _force_merge_once(ns):
    """A policy of ``ns``'s package: merge the first sibling pair, once."""
    class ForceMergeOnce(ns.core.RepartitionPolicy):
        name = "force-merge"

        def __init__(self):
            self.done = False

        def propose(self, ctx):
            if self.done:
                return []
            pairs = ctx.state.mergeable_pairs(ctx.lattice, live=ctx.specs)
            if not pairs:
                return []
            self.done = True
            return [ns.core.Move("merge", pairs[0])]

    return ForceMergeOnce()


@pytest.mark.parametrize("grace", [100, 0])
def test_drain_first_matches_reference(grace):
    def run(ns):
        sched = _sched(ns, lambda S: _fragmented(S)[:2])
        for a in ns.core.make_workload(6, seed=0, work_range=(40.0, 60.0),
                                       mem_range_gb=(1.0, 3.0)):
            sched.add_job(a, 0.0)
        for k in range(4):
            sched.run_round(float(k))
        epoch = sched._epoch
        coord = ns.core.RepartitionCoordinator(
            sched, _force_merge_once(ns), drain_grace=grace)
        coord.tick(4.0)
        return (_commit_rows(sched), sorted(sched.slices), coord.stats(),
                [(m.kind, m.targets, n) for m, n in coord.draining],
                sched._epoch > epoch)

    ref, port = _both(run)
    assert port == ref
    if grace == 0:  # the forced revocation went through the failure path
        assert ref[2]["n_forced"] > 0 and ref[4]
        assert any(row[0] == "lost" for row in ref[0])


@pytest.mark.parametrize("pipeline", [False, True])
def test_crash_resume_across_repartition_boundary(pipeline, tmp_path):
    def run(ns, tag, crash):
        c = ns.core
        plan = c.FaultPlan(seed=7, events=(
            c.FaultEvent(t=40.5, kind=SCHEDULER_CRASH),
            c.FaultEvent(t=120.5, kind=SCHEDULER_CRASH))) if crash else None
        store = ns.checkpoint.CheckpointStore(str(tmp_path / tag))
        return _sim_key(c.simulate(
            _sched(ns, _fragmented), _hetero_workload(ns),
            c.SimConfig(t_end=300.0, seed=0, pipeline=pipeline,
                        repartition=c.FragmentationAware()),
            faults=plan, checkpoint=store, checkpoint_every=5))

    whole = run(PORT, "whole", False)
    assert whole[5]["n_merges"] > 0
    assert run(PORT, "crash", True) == whole == run(REF, "ref", True)


def test_coordinator_pickles_with_scheduler():
    c = PORT.core
    sched = _sched(PORT, _fragmented)
    coord = c.RepartitionCoordinator(sched, c.FragmentationAware())
    for a in _hetero_workload(PORT, 8):
        sched.add_job(a, 0.0)
    for k in range(6):
        coord.tick(float(k))
        sched.run_round(float(k))
    sched2, coord2 = pickle.loads(pickle.dumps((sched, coord)))
    assert coord2.scheduler is sched2
    assert coord2.state.intervals == coord.state.intervals
    assert coord2.stats() == coord.stats()


# ---------------------------------------------------------------------------
# the migration ladder
# ---------------------------------------------------------------------------

def _busy(ns, n_jobs=10, granularity=0.0):
    sched = _sched(ns, _mig_slices)
    for a in _mig_workload(ns, n_jobs, granularity=granularity):
        sched.add_job(a, 0.0)
    for k in range(3):
        sched.run_round(float(k))
    return sched


def _ladder_ops(ns):
    out = []
    sched = _busy(ns)
    sid = sched.commitments[0].variant.slice_id
    lost = sched.revoke_slice(sid, 3.0)
    epoch = sched._epoch
    out.append((len(lost), sched.revoke_slice(sid, 4.0), sched._epoch == epoch,
                dict(sched.loss_reasons), sched.revoke_slice("nope", 0.0)))
    # partial-progress credit
    sched = _busy(ns, granularity=5.0)
    v = sched.commitments[0].variant
    agent = sched.agents[v.job_id]
    rec = sched.preempt(v, 0.5 * (v.t_start + v.t_end),
                        work_done=min(5.0, float(v.payload["work"])))
    out.append((rec.status, rec.work_credited, rec.t_end, agent.work_done,
                agent.biddable_work, sched.n_preempted_total,
                dict(sched.loss_reasons), sched.preempt(v, 2.0, work_done=1.0)))
    # live migration to another slice
    sched = _busy(ns, granularity=5.0)
    c0 = sched.commitments[0]
    v = c0.variant
    target = next(s for s in sorted(sched.slices) if s != v.slice_id)
    new_v = sched.migrate_commitment(
        v, 2.0, slice_id=target, t_start=500.0, duration=30.0,
        residual_work=float(v.payload["work"]) - 5.0, credited_work=5.0)
    succ = [d for d in sched.commitments if d.variant is new_v][0]
    out.append((new_v.variant_id, new_v.slice_id, float(new_v.payload["work"]),
                succ.score, _commit_rows(sched), sched.n_migrated_total,
                sched.agents[v.job_id].work_done,
                sched.migrate_commitment(
                    sched.commitments[1].variant, 1.0, slice_id="nope",
                    t_start=5.0, duration=5.0, residual_work=1.0)))
    # the executor's truncation path
    sched = _sched(ns, _mig_slices)
    ex = ns.events.ExecutionPlumbing(sched, ns.events.EventHeap(),
                                     np.random.default_rng(0), runtime_cv=0.0,
                                     check_capacity=False)
    for a in _mig_workload(ns, 8):
        sched.add_job(a, 0.0)
    v = sched.run_round(0.0).selected[0]
    end = v.t_start + 2.0 * (v.t_end - v.t_start)
    ex.running[v.slice_id] = (v, end)
    out.append((ex.complete(v.slice_id, end)[1], sched.agents[v.job_id].work_done,
                _commit_rows(sched)))
    return out


def test_ladder_primitives_match_reference():
    ref, port = _both(_ladder_ops)
    assert port == ref


def _revoke_plan(c, t=30.5):
    return c.FaultPlan(seed=0, events=(
        c.FaultEvent(t=t, kind=SLICE_REVOKED, target="S0"),))


@pytest.mark.parametrize("migration", [None, "default", "budget0"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_revocation_ladder_matches_reference(migration, pipeline):
    def run(ns):
        c = ns.core
        mig = {None: None, "default": c.MigrationConfig(),
               "budget0": c.MigrationConfig(migration_budget=0)}[migration]
        gran = 0.0 if migration == "budget0" else 4.0
        return _sim_key(c.simulate(
            _sched(ns, _mig_slices), _mig_workload(ns, 14, granularity=gran),
            c.SimConfig(t_end=220.0, seed=0, pipeline=pipeline, migration=mig),
            faults=_revoke_plan(c)))

    ref, port = _both(run)
    assert port == ref
    if migration == "default":
        assert ref[7][0] + ref[7][1] > 0  # the ladder fired


@pytest.mark.parametrize("seed", [0, 5])
def test_progress_conservation_matches_reference(seed):
    def run(ns):
        c = ns.core
        plan = c.FaultPlan.generate(seed, t_end=150.0,
                                    slice_ids=[f"S{k}" for k in range(4)],
                                    revoke_rate=0.004)
        r = c.simulate(_sched(ns, _mig_slices),
                       _mig_workload(ns, 12, granularity=3.0, seed=seed + 1),
                       c.SimConfig(t_end=150.0, seed=seed,
                                   migration=c.MigrationConfig()),
                       faults=plan)
        for a in r.scheduler.agents.values():
            assert -1e-6 <= a.work_done <= a.spec.total_work + 1e-6
        return _sim_key(r)

    ref, port = _both(run)
    assert port == ref


@pytest.mark.parametrize("pipeline", [False, True])
def test_crash_resume_across_migration_boundary(pipeline, tmp_path):
    def run(ns, tag, crash):
        c = ns.core
        events = (c.FaultEvent(t=30.5, kind=SLICE_REVOKED, target="S0"),)
        if crash:
            events += (c.FaultEvent(t=45.5, kind=SCHEDULER_CRASH),)
        store = ns.checkpoint.CheckpointStore(str(tmp_path / tag))
        return _sim_key(c.simulate(
            _sched(ns, _mig_slices), _mig_workload(ns, 14, granularity=4.0),
            c.SimConfig(t_end=220.0, seed=0, pipeline=pipeline,
                        migration=c.MigrationConfig()),
            faults=c.FaultPlan(seed=0, events=events), checkpoint=store,
            checkpoint_every=5))

    whole = run(PORT, "whole", False)
    assert whole[7][0] + whole[7][1] > 0
    assert run(PORT, "crash", True) == whole == run(REF, "ref", True)


def test_planner_pickles_with_scheduler():
    sched = _busy(PORT, granularity=5.0)
    planner = PORT.core.MigrationPlanner(sched)
    planner.evacuate(sched.commitments[0].variant.slice_id, 3.0)
    sched2, planner2 = pickle.loads(pickle.dumps((sched, planner)))
    assert planner2.scheduler is sched2
    assert (planner2.n_migrated, planner2.n_preempted, planner2.n_lost) == (
        planner.n_migrated, planner.n_preempted, planner.n_lost)


# ---------------------------------------------------------------------------
# the service on the repartitioned pod
# ---------------------------------------------------------------------------

def _pod_soak(ns, impl, pipeline, t_end):
    sched = _sched(ns, _pod, score_impl=impl, wis_impl=impl)
    arr = ns.service.PoissonArrivals(8.0, seed=0, work_range=(8.0, 40.0),
                                     qos_fraction=0.3, deadline_slack=(2.0, 6.0))
    svc = ns.service.JasdaService(sched, arr, config=ns.service.ServiceConfig(
        t_end=t_end, seed=0, max_bucket_m=32768, pipeline=pipeline,
        repartition=ns.core.FragmentationAware(), migration=True))
    stats = svc.run()
    rounds = [r for r in sched.log if r.n_windows]
    return {"awards": [(r.round, r.t, r.variant_id, r.job_id, r.slice_id)
                       for r in svc.award_log],
            "stats": json.dumps(dataclasses.asdict(stats)),
            "coord": svc.repartition.stats(),
            "windows": [r.n_windows for r in rounds],
            "bids": [r.n_bids for r in rounds],
            "failed": (sched.backend_health.failed_backends()
                       if ns is PORT else {})}


def test_service_repartitions_pod_as_reference():
    ref = _pod_soak(REF, "numpy", True, 50.0)
    port = _pod_soak(PORT, "numpy", True, 50.0)
    assert port == ref
    assert ref["coord"]["n_splits"] > 0 and len(set(ref["windows"])) > 1


def test_service_repartitions_pod_on_device_backends():
    """Splits change W between rounds under the device pipeline: the
    speculated round built before a move is thrown away on the epoch
    bump, and pipelined, serial and the reference agree."""
    ref = _pod_soak(REF, "ref", True, 55.0)
    pipe = _pod_soak(PORT, "torch", True, 55.0)
    serial = _pod_soak(PORT, "cuda", False, 55.0)
    assert pipe == ref == serial
    assert ref["coord"]["n_splits"] > 0
    assert min(ref["windows"]) < max(ref["windows"])
    assert max(ref["bids"]) > 1024


def test_f32_scores_tie_where_host_f64_does_not():
    """The pod soak's first round where the float32 backends part from
    host float64 numpy (t = 98, 6,749 bids): two bids on one window score
    5.3e-9 apart in float64 and equal in float32.  The port's plain torch
    scoring ties exactly as the reference's jnp oracle, so both take the
    earlier-ending bid, where float64 takes the higher-scoring one; both
    packages' numpy agree with each other."""
    from repro.core.wis import wis_select as ref_wis_select
    from repro.kernels.jasda_score.ops import score_variants as ref_score
    from repro_torch.core.wis import wis_select
    from repro_torch.kernels.jasda_score.ops import score_variants

    fj = np.array([[0.5266229819365715], [0.5236471643121918]])
    fs = np.array([[0.02074625034428896, 1.0, 0.44067718218160423,
                    0.061942513281213696],
                   [0.01831219483766179, 1.0, 0.5566579995041894,
                    0.02369925041257226]])
    alphas, betas, lam = np.array([1.0]), np.array([0.4, 0.2, 0.1, 0.2]), 0.5
    zeros = np.zeros((2, 1))
    kw = dict(lam=lam, capacity=1.0, theta=1.0)
    ref32 = np.asarray(ref_score(fj, fs, alphas, betas, zeros, zeros,
                                 impl="ref", **kw)[0])
    port32 = score_variants(fj, fs, alphas, betas, zeros, zeros, impl="torch",
                            device="cpu", **kw)[0].numpy()
    f64 = lam * np.clip(fj @ alphas, 0, 1) + (1 - lam) * np.clip(fs @ betas, 0, 1)
    assert port32.tobytes() == ref32.tobytes() and port32[0] == port32[1]
    assert 0 < f64[0] - f64[1] < 1e-8
    starts = [367.4780318523601] * 2
    ends = [382.63362348555376, 380.85549246627187]
    for w, winner in ((f64, 0), (port32.astype(np.float64), 1)):
        sel, total = wis_select(starts, ends, w)
        ref_sel, ref_total = ref_wis_select(starts, ends, w)
        assert sel.tolist() == ref_sel.tolist() == [winner]
        assert total == ref_total
