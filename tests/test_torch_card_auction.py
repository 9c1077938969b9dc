"""The auction path on the card: K1 and K2 inside whole runs.

The 64-slice MIG cluster's simulation, the streaming service, its
checkpoint and crash recovery, repartitioning and the auction mesh, each
run through the kernels on the card (``impl="cuda"``) and held to the
same run through another backend: the kernels serial, the plain torch
versions on the card or on the host, host float64 numpy, or one card in
place of a mesh.  Commit and award logs must be identical and no run may
mark a backend failed.  The service soaks run to t = 100 (the crash at
50) and the simulations to t = 20.  Every test skips without a card
(``tests/torch_card.py``).
"""
import contextlib
import dataclasses
import json
import pickle

import numpy as np
import pytest

from repro_torch import core, service
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.clearing import clear_round
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.scoring import ScoringPolicy
from repro_torch.core.trp import fmp_standard
from repro_torch.core.types import Variant, Window
from repro_torch.kernels import common
from repro_torch.kernels.jasda_score import kernel as k1
from repro_torch.kernels.wis_dp import kernel as k2
from repro_torch.launch.mesh import (AUCTION_AXIS, Mesh, make_auction_mesh,
                                     mesh_chips)
from torch_card import card  # noqa: F401  (the fixture)

pytestmark = pytest.mark.card

GB = 1 << 30


def cluster(S):
    """16 H100s cut by MIG into 3g.40gb + 2g.20gb + 2 x 1g.10gb: 64 slices."""
    return [S(f"gpu{g:02d}-{name}", cap * GB, n_chips=units) for g in range(16)
            for name, cap, units in (("3g.40gb", 40, 3), ("2g.20gb", 20, 2),
                                     ("1g.10gb-a", 10, 1), ("1g.10gb-b", 10, 1))]


#: 500 jobs on the 64-slice cluster, 21 rounds (M bucket 32768 among them)
SIM = dict(slices=cluster, jobs=dict(n_jobs=500, seed=0, arrival_rate=100.0,
                                     mem_range_gb=(2.0, 36.0)),
           sim=dict(t_end=20.0, seed=1))
#: a small seeded run, three slices
SMALL = dict(slices=lambda S: [S("s20", 20 * GB, n_chips=4),
                               S("s10", 10 * GB, n_chips=2),
                               S("s5", 5 * GB, n_chips=1)],
             jobs=dict(n_jobs=40, seed=3, arrival_rate=0.3),
             sim=dict(t_end=900.0, seed=2))


@contextlib.contextmanager
def counted():
    """K1's and K2's launches and shapes while entered, counted from 0."""
    for k, name in ((k1, "jasda_score"), (k2, "wis_batch")):
        k.LAUNCHES[name] = 0
        k.SHAPES.clear()
    out = {}
    yield out
    out["launches"] = {"jasda_score": k1.LAUNCHES["jasda_score"],
                       "wis_batch": k2.LAUNCHES["wis_batch"]}
    out["shapes"] = {"jasda_score": dict(k1.SHAPES), "wis_batch": dict(k2.SHAPES)}


def run_sim(impl, device, *, slices, jobs, sim, pipeline=True, mesh=None,
            **sim_kw):
    """One ``simulate`` run: its commit log, read from the scheduler that
    finished it (the one a ``scheduler_crash`` restored), and summary."""
    cfg = SchedulerConfig.from_policy(
        core.Policy(per_agent_theta=True), score_impl=impl, wis_impl=impl,
        device=device, mesh=mesh)
    res = core.simulate(core.JasdaScheduler(slices(core.SliceSpec), cfg),
                        core.make_workload(**jobs),
                        core.SimConfig(pipeline=pipeline, **sim), **sim_kw)
    sched = res.scheduler
    assert not sched.backend_health.failed_backends()
    return {"commits": [(c.variant_id, c.slice_id, c.t_start, c.score)
                        for c in sched.commit_log],
            "summary": res.summary()}


def same_run(a, b):
    assert a["commits"] == b["commits"]
    assert a["summary"] == b["summary"]


@pytest.fixture(scope="module")
def runs(card):
    """The 64-slice simulation through the kernels, pipelined and serial,
    each with its launches counted."""
    out = {}
    for pipeline in (True, False):
        with counted() as c:
            out[pipeline] = run_sim("cuda", card, pipeline=pipeline, **SIM)
        out[pipeline].update(c)
    return out


@pytest.fixture(scope="module")
def small(card):
    return run_sim("cuda", card, **SMALL)


def test_pipelined_and_serial_rounds_commit_alike(card, runs):
    pipe, serial = runs[True], runs[False]
    assert pipe["commits"]
    same_run(serial, pipe)
    for run in (pipe, serial):
        assert all(run["launches"].values()), run["launches"]


def test_plain_versions_on_the_card_commit_as_the_kernels(card):
    """The first four rounds (to t = 3, the largest pools): the plain torch
    versions take ~8x the kernels' wall."""
    sim = dict(SIM, sim=dict(SIM["sim"], t_end=3.0))
    with counted() as c:
        plain = run_sim("torch", card, **sim)
    assert not any(c["launches"].values())
    kernels = run_sim("cuda", card, **sim)
    assert kernels["commits"]
    same_run(plain, kernels)


def test_small_run_on_the_card_is_the_host_run(card, small):
    host = run_sim("torch", "cpu", **SMALL)
    assert small["commits"]
    assert [c[:3] for c in small["commits"]] == [c[:3] for c in host["commits"]]
    assert small["summary"] == host["summary"]
    assert max(abs(a[3] - b[3]) for a, b in
               zip(small["commits"], host["commits"])) <= 3e-5


def test_each_kernel_source_builds_once(card, runs):
    """The kernels take every shape, bucket and row slice at run time."""
    counts = common.build_counts()
    assert set(counts.values()) <= {1}, counts


# ---------------------------------------------------------------------------
# The streaming service
# ---------------------------------------------------------------------------

#: open-loop arrivals (rate 8 on the 64-slice cluster: pools of a few
#: hundred to a few thousand bids a round)
ARRIVALS = dict(rate=8.0, seed=0, work_range=(8.0, 40.0), qos_fraction=0.3,
                deadline_slack=(2.0, 6.0))
SOAK_T_END, CRASH_T, CHECKPOINT_EVERY = 100.0, 50.0, 25
#: the repartitioned pod's horizon, and the first of its rounds whose
#: float32 scores tie where the float64 ones do not (two bids 5.3e-9 apart):
#: host numpy picks other winners from there on
POD_T_END, POD_F64_TIE_T = 120.0, 98.0


def run_service(impl, device, *, pipeline=True, slices=cluster,
                horizon=SOAK_T_END, t_end=None, checkpoint=None, **svc_cfg):
    """A soak of ``ARRIVALS`` configured to ``horizon`` and run to ``t_end``
    (the horizon when None)."""
    sched = core.JasdaScheduler(slices(core.SliceSpec), SchedulerConfig(
        score_impl=impl, wis_impl=impl, device=device))
    arr = dict(ARRIVALS)
    svc = service.JasdaService(
        sched, service.PoissonArrivals(arr.pop("rate"), **arr),
        config=service.ServiceConfig(t_end=horizon, seed=0,
                                     max_bucket_m=32768, pipeline=pipeline,
                                     **svc_cfg),
        admission=service.AcceptAll())
    stats = svc.run(t_end, checkpoint=checkpoint,
                    checkpoint_every=CHECKPOINT_EVERY)
    return digest(svc, stats)


def digest(svc, stats):
    """What two soaks must agree on: the award log and the stats (as JSON,
    so that NaN compares)."""
    assert not svc.scheduler.backend_health.failed_backends()
    return {"awards": [(r.round, r.t, r.variant_id, r.job_id, r.slice_id)
                       for r in svc.award_log],
            "stats": json.dumps(dataclasses.asdict(stats)),
            "repartition": svc.repartition and svc.repartition.stats()}


@pytest.fixture(scope="module")
def soak(card):
    with counted() as c:
        out = run_service("cuda", card)
    assert all(c["launches"].values()), c["launches"]
    assert out["awards"]
    return out


@pytest.mark.parametrize("impl,pipeline", [("cuda", False), ("numpy", True)])
def test_soak_is_the_same_through_every_backend(card, soak, impl, pipeline):
    assert run_service(impl, card if impl == "cuda" else "cpu",
                       pipeline=pipeline) == soak


def test_soak_restored_from_its_checkpoint_equals_the_unbroken_one(
        card, soak, tmp_path):
    store = CheckpointStore(tmp_path, keep=3)
    run_service("cuda", card, t_end=CRASH_T, checkpoint=store)
    resumed = service.JasdaService.restore(store)
    assert 0 < resumed.round_count
    assert digest(resumed, resumed.run()) == soak


def test_repartitioning_on_the_card_is_the_host_torch_run(card):
    """A 64-chip pod of eight 8-chip slices under FragmentationAware and
    the migration ladder: the kernels pipelined against the plain torch
    versions on the host, serial; host float64 numpy up to the f32 tie."""
    def pod(S):
        return [S(f"s{i}", 80 * GB, n_chips=8) for i in range(8)]

    def pod_run(impl, device, pipeline=True):
        return run_service(impl, device, pipeline=pipeline, slices=pod,
                           horizon=POD_T_END,
                           repartition=core.FragmentationAware(),
                           migration=True)

    on_card = pod_run("cuda", card)
    assert pod_run("torch", "cpu", pipeline=False) == on_card
    assert on_card["repartition"]["n_splits"] > 0
    host = pod_run("numpy", "cpu")
    parted = next((a for a, b in zip(host["awards"], on_card["awards"])
                   if a != b), None)
    assert parted is None or parted[1] >= POD_F64_TIE_T, parted


def test_crash_replay_equals_the_unbroken_run(card, runs, tmp_path):
    plan = core.FaultPlan(seed=0, events=(
        core.FaultEvent(t=10.5, kind="scheduler_crash"),))
    crashed = run_sim("cuda", card, **SIM, faults=plan,
                      checkpoint=CheckpointStore(tmp_path),
                      checkpoint_every=5)
    same_run(crashed, runs[True])


# ---------------------------------------------------------------------------
# The auction mesh: the round's device work in row shards of the card
# ---------------------------------------------------------------------------

SHARDS = 4


def sharded_shapes(shapes: dict, n: int):
    """The launches ``shapes`` (rows first in each key -> launches) become
    on an ``n``-shard mesh: a launch whose rows n divides becomes n launches
    of rows / n, any other stays whole.  (shapes, split, whole dispatches)"""
    out, split, whole = {}, 0, 0
    for key, count in shapes.items():
        if key[0] % n == 0:
            key, split = (key[0] // n,) + tuple(key[1:]), split + count
            count *= n
        else:
            whole += count
        out[key] = out.get(key, 0) + count
    return out, split, whole


def mesh_round(m: int, n_windows: int, *, rng, n_jobs: int = 23):
    """A random round on float32-exact grids (12-bit utilities, half-step
    intervals)."""
    windows = [Window(f"s{k}", (6 + 2 * (k % 5)) * GB, 0.0, 100.0)
               for k in range(n_windows)]
    fmp = fmp_standard(1 * GB, 2 * GB, 0.1 * GB)
    pool = []
    for i in range(m):
        w = windows[int(rng.integers(0, n_windows))]
        t0 = float(rng.integers(0, 180)) / 2
        dur = min(float(rng.integers(2, 40)) / 2, 100.0 - t0)
        if dur > 0:
            pool.append(Variant(
                job_id=f"J{i % n_jobs}", slice_id=w.slice_id, t_start=t0,
                duration=dur, fmp=fmp,
                local_utility=float(rng.integers(1, 1 << 12)) / (1 << 12),
                declared_features={}, payload={"work": dur},
                variant_id=f"v{i}"))
    return windows, pool


def round_sig(rr):
    """Selections, scores, feedback and totals of a cleared round."""
    return ([tuple(v.variant_id for v in r.selected) for r in rr.results],
            tuple(rr.scores), rr.selected_idx, rr.total_score, rr.n_conflicts)


def test_degenerate_mesh_is_one_card(card, runs):
    one = make_auction_mesh()
    assert mesh_chips(one) == 1 and one.devices == (card,)
    with counted() as c:
        run = run_sim("cuda", card, mesh=one, **SIM)
    same_run(run, runs[True])
    assert c["shapes"] == runs[True]["shapes"]


def test_three_shards_fall_back_to_one_launch(card):
    """3 divides no pow2 bucket: the round launches unsharded."""
    windows, pool = mesh_round(700, 5, rng=np.random.default_rng(4))
    out = []
    for mesh in (None, Mesh((card,) * 3, (AUCTION_AXIS,), (3,))):
        with counted() as c:
            rr = clear_round(windows, pool, ScoringPolicy(), score_impl="cuda",
                             wis_impl="cuda", device=card, mesh=mesh)
        out.append((round_sig(rr), c["shapes"]))
    assert out[0] == out[1]


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "serial"])
def test_four_shards_commit_as_one_card(card, runs, pipeline):
    """K1 launches 4x at M / 4 rows and K2 at W / 4 windows; a dispatch
    whose rows 4 does not divide launches once, whole."""
    mesh = make_auction_mesh(SHARDS, devices=[card] * SHARDS)
    assert mesh_chips(mesh) == SHARDS
    with counted() as c:
        run = run_sim("cuda", card, pipeline=pipeline, mesh=mesh, **SIM)
    same_run(run, runs[pipeline])
    for kernel in ("jasda_score", "wis_batch"):
        want, split, whole = sharded_shapes(runs[pipeline]["shapes"][kernel],
                                            SHARDS)
        assert c["shapes"][kernel] == want, kernel
        assert c["launches"][kernel] == SHARDS * split + whole, kernel


def test_large_sharded_round_is_one_card(card):
    """2^17 bids over 24 windows, then 2^17 - 4097 in the same bucket: no
    kernel builds again between them."""
    mesh = make_auction_mesh(SHARDS, devices=[card] * SHARDS)
    rng = np.random.default_rng(100)
    before = common.build_counts()
    for m in (1 << 17, (1 << 17) - 4097):
        windows, pool = mesh_round(m, 24, rng=rng, n_jobs=101)
        whole, split = (round_sig(clear_round(
            windows, pool, ScoringPolicy(), wis_impl="cuda", **where))
            for where in ({"device": card}, {"mesh": mesh}))
        assert whole == split
        assert sum(map(len, whole[0]))
    assert common.build_counts() == before


def test_torch_backend_on_four_shards_is_the_cuda_run(card, small):
    mesh = make_auction_mesh(SHARDS, devices=[card] * SHARDS)
    same_run(run_sim("torch", card, mesh=mesh, **SMALL), small)


def test_meshed_scheduler_refuses_pickle(card, tmp_path):
    mesh = make_auction_mesh(SHARDS, devices=[card] * SHARDS)
    cfg = SchedulerConfig.from_policy(core.Policy(per_agent_theta=True),
                                      score_impl="cuda", wis_impl="cuda",
                                      device=card, mesh=mesh)
    sched = core.JasdaScheduler(cluster(core.SliceSpec), cfg)
    store = CheckpointStore(tmp_path)
    with pytest.raises(ValueError, match="mesh"):
        pickle.dumps(sched)
    with pytest.raises(ValueError, match="mesh"):
        store.save_state(1, sched)
    assert store.latest_step() is None
