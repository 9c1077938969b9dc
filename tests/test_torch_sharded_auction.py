"""Mesh-sharded auction rounds in the port: sharded == single-device, byte-wise.

The port's mirror of ``tests/test_sharded_auction.py``.  Splitting a round
over an auction mesh -- the pooled-bid rows of the scoring launch and the
(W, L) window rows of the batched WIS settle -- changes WHERE the round
computes, never WHAT it selects.  The port's mesh is a tuple of torch
devices driven from one process (``repro_torch.launch.mesh``); here it is
built over virtual shards, ``["cpu"] * 4`` and ``["cpu"] * 8``, through
the port's own ``devices=`` argument, so every test runs on the host.

Each sharded round is held byte for byte against the port's unsharded
round, and against the JAX package's unsharded ``clear_round(...,
wis_impl="ref")`` on the same inputs (the same selections, scores within
3e-5).  One test runs the JAX package's own sharded rounds on 4 virtual
XLA devices in a subprocess and compares.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as ref_core
import repro.core.clearing as ref_clearing
import repro.core.scheduler as ref_scheduler
import repro.core.policy as ref_policy
import repro.core.scoring as ref_scoring
import repro.core.trp as ref_trp
import repro.core.types as ref_types
import repro_torch.core as port_core
import repro_torch.core.clearing as port_clearing
import repro_torch.core.scheduler as port_scheduler
import repro_torch.core.policy as port_policy
import repro_torch.core.scoring as port_scoring
import repro_torch.core.trp as port_trp
import repro_torch.core.types as port_types
from repro.distributed.sharding import guard_spec as ref_guard_spec
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.pipeline import pipelined_clear_rounds
from repro_torch.core.wis import make_round_selector
from repro_torch.distributed.sharding import (auction_row_spec, guard_spec,
                                              mesh_size, replicated_spec,
                                              row_shards, spec_sharded)
from repro_torch.kernels.jasda_score import ops as score_ops
from repro_torch.kernels.wis_dp import ops as wis_ops
from repro_torch.launch.mesh import (AUCTION_AXIS, Mesh, make_auction_mesh,
                                     make_production_mesh, mesh_chips)

ROOT = Path(__file__).resolve().parents[1]
GB = 1 << 30
SCORE_ATOL = 3e-5
REF = dict(core=ref_core, clearing=ref_clearing, policy=ref_policy,
           scoring=ref_scoring, trp=ref_trp, types=ref_types,
           scheduler=ref_scheduler)
PORT = dict(core=port_core, clearing=port_clearing, policy=port_policy,
            scoring=port_scoring, trp=port_trp, types=port_types,
            scheduler=port_scheduler)
BACKENDS = [("GreedyWIS", {}), ("GlobalAssignment", {}), ("FairShare", {}),
            ("FairShare", dict(age_weight=0.0, spread=0.5))]


def _mesh(n):
    return make_auction_mesh(n, devices=["cpu"] * n)


def _backend(ns, spec):
    name, kw = spec
    return getattr(ns["policy"], name)(**kw)


def _mk_round(ns, seed_or_rng, m, n_windows, n_jobs=23):
    """The reference test's random round, on float32-exact grids (12-bit
    utilities, half-step intervals), built in package ``ns`` from one
    seeded generator so both packages see the same pool."""
    rng = (np.random.default_rng(seed_or_rng)
           if isinstance(seed_or_rng, int) else seed_or_rng)
    Window, Variant = ns["types"].Window, ns["types"].Variant
    windows = [Window(f"s{k}", (6 + 2 * (k % 5)) * GB, 0.0, 100.0)
               for k in range(n_windows)]
    fmp = ns["trp"].fmp_standard(1 * GB, 2 * GB, 0.1 * GB)
    pool = []
    for i in range(m):
        w = windows[int(rng.integers(0, n_windows))]
        t0 = float(rng.integers(0, 180)) / 2
        dur = float(rng.integers(2, 40)) / 2
        if t0 + dur > 100.0:
            dur = 100.0 - t0
        if dur <= 0:
            continue
        pool.append(Variant(
            job_id=f"J{i % n_jobs}", slice_id=w.slice_id, t_start=t0,
            duration=dur, fmp=fmp,
            local_utility=float(rng.integers(1, 1 << 12)) / (1 << 12),
            declared_features={}, payload={"work": dur}, variant_id=f"v{i}"))
    return windows, pool


def _sig(rr):
    """Byte-level round signature: per-window selections, scores, feedback
    inputs (selected_idx), totals."""
    return ([tuple(v.variant_id for v in r.selected) for r in rr.results],
            tuple(rr.scores), rr.selected_idx, rr.total_score, rr.n_conflicts)


def _same_as_reference(port_rr, ref_rr):
    a, b = _sig(port_rr), _sig(ref_rr)
    assert a[0] == b[0] and a[2] == b[2] and a[4] == b[4]
    np.testing.assert_allclose(np.asarray(a[1], np.float64),
                               np.asarray(b[1], np.float64),
                               atol=SCORE_ATOL, rtol=0)
    assert abs(a[3] - b[3]) <= SCORE_ATOL * max(1, len(a[1]))


def _canon(spec):
    """A spec with one-axis entries written as the axis name, the form a
    ``PartitionSpec`` keeps them in (``PS(("bids",))`` reads ``("bids",)``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _draw(seed):
    rng = np.random.default_rng(seed)
    # ragged M spanning: tiny (empty shards after padding), below/above the
    # SMALL_POOL_M device threshold, and window counts that leave some
    # windows empty / all-masked
    m = int(rng.choice([3, 40, 257, 900, 2100]))
    n_windows = int(rng.integers(1, 12))
    return rng, m, n_windows


AGES = {f"J{i}": (i % 7) / 6.0 for i in range(23)}


def _check_round_parity(seed, meshes, *, backend, wis_impl="torch",
                        pipelined=False):
    """Sharded port rounds == the port's unsharded rounds byte for byte,
    and == the reference's unsharded "ref" rounds (selections; scores
    within 3e-5)."""
    rng, m, n_windows = _draw(seed)
    n_rounds = 3 if pipelined else 1
    # the same generator state builds each package's rounds
    state = rng.bit_generator.state
    port_rounds = [_mk_round(PORT, rng, m, n_windows) for _ in range(n_rounds)]
    rng.bit_generator.state = state
    ref_rounds = [_mk_round(REF, rng, m, n_windows) for _ in range(n_rounds)]
    pol, rpol = port_scoring.ScoringPolicy(), ref_scoring.ScoringPolicy()
    kw = dict(ages=AGES, wis_impl=wis_impl, score_impl=wis_impl)
    serial = [port_clearing.clear_round(w, p, pol, clearing=_backend(PORT, backend),
                                        device="cpu", **kw)
              for w, p in port_rounds]
    ref = [ref_clearing.clear_round(w, p, rpol, ages=AGES,
                                    clearing=_backend(REF, backend),
                                    wis_impl="ref", score_impl="ref")
           for w, p in ref_rounds]
    for mesh in meshes:
        if pipelined:
            sharded = pipelined_clear_rounds(
                port_rounds, pol, clearing=_backend(PORT, backend), mesh=mesh,
                **kw)
        else:
            sharded = [port_clearing.clear_round(
                w, p, pol, clearing=_backend(PORT, backend), mesh=mesh, **kw)
                for w, p in port_rounds]
        assert [_sig(a) for a in serial] == [_sig(b) for b in sharded]
    for a, b in zip(serial, ref):
        _same_as_reference(a, b)


# ---------------------------------------------------------------------------
# mesh builders and specs
# ---------------------------------------------------------------------------


def test_auction_mesh_shape_and_axis():
    for n in (4, 8):
        mesh = _mesh(n)
        assert mesh.axis_names == (AUCTION_AXIS,)
        assert mesh.shape == {AUCTION_AXIS: n}
        assert mesh_chips(mesh) == n == len(mesh.devices)
        assert all(d == torch.device("cpu") for d in mesh.devices)
        assert hash(mesh) == hash(_mesh(n)) and mesh == _mesh(n)
    if not torch.cuda.is_available():
        # devices=None takes the visible cards and never the host
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_auction_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_auction_mesh(4, devices=["cuda"] * 4)
    with pytest.raises(ValueError):
        Mesh((torch.device("cpu"),) * 3, (AUCTION_AXIS,), (4,))


@pytest.mark.parametrize("avail", [4, 8])
def test_auction_mesh_clamps_to_pow2_floor(avail):
    for req in (1, 2, 3, 5, 7, 8, 100):
        n = mesh_chips(make_auction_mesh(req, devices=["cpu"] * avail))
        assert n & (n - 1) == 0
        assert n <= min(req, avail)
        assert 2 * n > min(req, avail)  # the LARGEST such power of two
    assert mesh_chips(make_auction_mesh(devices=["cpu"] * avail)) == avail
    assert mesh_chips(make_auction_mesh(devices=["cpu"] * 6)) == 4


def test_production_mesh_degrades_without_raising():
    # fewer devices than the fixed shape: the builder falls back, not raises
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * 3)
        assert mesh.shape == {"data": 3} and mesh_chips(mesh) == 3
    if not torch.cuda.is_available():
        # devices=None takes the visible cards and never the host
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_production_mesh()
    small = make_production_mesh(devices=["cpu"] * 4)
    assert small.shape == {"data": 4}
    full = make_production_mesh(devices=["cpu"] * 256)
    assert full.shape == {"data": 16, "model": 16}
    pods = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_chips(pods) == 512


def test_row_spec_guard_falls_back_unsharded():
    from repro.distributed.sharding import auction_row_spec as ref_row_spec

    assert mesh_size(None) == 1
    assert not spec_sharded(replicated_spec())
    for n in (4, 8):
        mesh = _mesh(n)
        assert mesh_size(mesh) == n
        assert spec_sharded(auction_row_spec(mesh, 16 * n))
        # a dim the mesh does not divide degrades to replicated (guard_spec)
        assert not spec_sharded(auction_row_spec(mesh, 16 * n + 1))
        assert row_shards(mesh, 16 * n) == n
        assert row_shards(mesh, 16 * n + 1) == 1
        for dim in (8, 16 * n, 16 * n + 1, 3, 256):
            # the JAX package's spec on the same mesh shape, entry for entry
            assert (_canon(auction_row_spec(mesh, dim))
                    == _canon(ref_row_spec(mesh, dim)))
    assert row_shards(None, 256) == 1
    assert row_shards(_mesh(1), 256) == 1


#: ``tests/test_sharding_rules.py``'s divisibility cases (its ``btd`` spec
#: on a (data=2, model=2) mesh), and more, as plain tuples
GUARD_CASES = [
    ((("data",), None, None), (3, 4, 8), (None, None, None)),
    ((("data",), None, None), (4, 4, 8), (("data",), None, None)),
    ((("data",), None, ("model",)), (4, 4, 6), (("data",), None, ("model",))),
    ((("data",), None, ("model",)), (4, 4, 7), (("data",), None, None)),
    ((("data", "model"),), (8, 3), (("data", "model"), None)),
    ((("data", "model"),), (6, 3), (None, None)),
    (("model", None), (2,), ("model",)),
    ((), (5, 5), (None, None)),
]


@pytest.mark.parametrize("spec,shape,want", GUARD_CASES)
def test_guard_spec_matches_reference(spec, shape, want):
    from jax.sharding import PartitionSpec as PS

    mesh_shape = {"data": 2, "model": 2}
    got = guard_spec(spec, shape, mesh_shape)
    assert got == want
    assert _canon(got) == _canon(ref_guard_spec(PS(*spec), shape, mesh_shape))
    assert PS(*got) == ref_guard_spec(PS(*spec), shape, mesh_shape)


# ---------------------------------------------------------------------------
# sharded == single-device byte-identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b[0] + str(len(b[1])))
@given(seed=st.integers(0, 10_000))
@settings(max_examples=3, deadline=None, derandomize=True)
def test_sharded_round_byte_identical_prop(backend, seed):
    _check_round_parity(seed, [_mesh(4)], backend=backend)


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b[0] + str(len(b[1])))
def test_sharded_round_byte_identical_seeded(backend):
    # seed 1 draws 257 bids over 6 windows: 4 and 8 shards split both
    # launches (the 512-row bucket, the 8-row window bucket)
    _check_round_parity(1, [_mesh(4), _mesh(8)], backend=backend)


@pytest.mark.parametrize("backend", [BACKENDS[0], BACKENDS[2]],
                         ids=lambda b: b[0])
def test_sharded_pipelined_equals_serial_unsharded(backend):
    for seed in (5, 17):
        _check_round_parity(seed, [_mesh(4)], backend=backend, pipelined=True)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_sharded_empty_and_all_masked_windows(impl):
    """Rounds where some shards see only padding and some windows clear
    empty must match unsharded exactly (including the empty results)."""
    pol = port_scoring.ScoringPolicy()
    # 2 bids across 9 windows: most windows all-masked, most shards empty
    windows, pool = _mk_round(PORT, 0, 2, 9)
    base = port_clearing.clear_round(windows, pool, pol, wis_impl=impl,
                                     score_impl=impl, device="cpu")
    for n in (4, 8):
        shard = port_clearing.clear_round(windows, pool, pol, wis_impl=impl,
                                          score_impl=impl, mesh=_mesh(n))
        assert _sig(base) == _sig(shard)
    assert len(base.results) == 9
    rwin, rpool = _mk_round(REF, 0, 2, 9)
    ref = ref_clearing.clear_round(rwin, rpool, ref_scoring.ScoringPolicy(),
                                   wis_impl="ref", score_impl="ref")
    _same_as_reference(base, ref)


class _Launches:
    """Counts the per-shard launches of both ops (the CUDA kernels' own
    counters only move on the card)."""

    def __init__(self, monkeypatch):
        self.score, self.settle = [], []
        real_score, real_settle = score_ops._launch_score, wis_ops._launch_settle

        def score(impl, d):
            self.score.append(tuple(d["fj"].shape))
            return real_score(impl, d)

        def settle(impl, p, **kw):
            self.settle.append(tuple(p.shape))
            return real_settle(impl, p, **kw)

        monkeypatch.setattr(score_ops, "_launch_score", score)
        monkeypatch.setattr(wis_ops, "_launch_settle", settle)

    def take(self):
        out = (list(self.score), list(self.settle))
        self.score.clear()
        self.settle.clear()
        return out


def test_odd_mesh_falls_back_identically(monkeypatch):
    """A hand-built non-pow2 mesh cannot divide pow2 buckets -- the guard
    degrades every launch to unsharded, with identical results and the
    same launches at the same shapes; a 4-shard mesh launches 4x at a
    quarter of the rows."""
    odd = Mesh((torch.device("cpu"),) * 3, (AUCTION_AXIS,), (3,))
    windows, pool = _mk_round(PORT, 4, 700, 5)
    pol = port_scoring.ScoringPolicy()
    seen = _Launches(monkeypatch)
    base = port_clearing.clear_round(windows, pool, pol, wis_impl="torch",
                                     device="cpu")
    base_launches = seen.take()
    shard = port_clearing.clear_round(windows, pool, pol, wis_impl="torch",
                                      mesh=odd)
    assert _sig(base) == _sig(shard)
    assert seen.take() == base_launches
    four = port_clearing.clear_round(windows, pool, pol, wis_impl="torch",
                                     mesh=_mesh(4))
    assert _sig(base) == _sig(four)
    score4, settle4 = seen.take()
    assert len(score4) == 4 * len(base_launches[0])
    assert len(settle4) == 4 * len(base_launches[1])
    assert {(m * 4, f) for m, f in score4} == set(base_launches[0])
    assert {(w * 4, l) for w, l in settle4} == set(base_launches[1])


def _scheduler(ns, mesh=None, **cfg_kw):
    core = ns["core"]
    cfg = ns["scheduler"].SchedulerConfig.from_policy(core.Policy(), **cfg_kw)
    if mesh is not None:
        cfg = dataclasses.replace(cfg, mesh=mesh)
    return core.JasdaScheduler(
        [core.SliceSpec("s20", 20 * GB, n_chips=4),
         core.SliceSpec("s10", 10 * GB, n_chips=2)], cfg)


def _run_sched(ns, mesh=None, **cfg_kw):
    core = ns["core"]
    sched = _scheduler(ns, mesh, **cfg_kw)
    core.simulate(sched, core.make_workload(30, seed=3, arrival_rate=0.3),
                  core.SimConfig(t_end=600.0, seed=2, pipeline=True))
    return ([(r.t, r.n_selected) for r in sched.log],
            [(c.variant_id, c.slice_id, c.t_start) for c in sched.commit_log],
            np.array([c.score for c in sched.commit_log]))


def test_scheduler_mesh_knob_byte_identical():
    """SchedulerConfig.mesh: full simulated auction (pipelined) sharded ==
    single-device, across logs and commit logs, and == the reference."""
    base = _run_sched(PORT, wis_impl="torch", score_impl="torch",
                      device="cpu")
    for n in (4, 8):
        shard = _run_sched(PORT, mesh=_mesh(n), wis_impl="torch",
                           score_impl="torch", device="cpu")
        assert shard[:2] == base[:2]
        np.testing.assert_array_equal(shard[2], base[2])
    ref = _run_sched(REF, wis_impl="ref", score_impl="ref")
    assert base[:2] == ref[:2] and len(base[1]) > 5
    np.testing.assert_allclose(base[2], ref[2], atol=SCORE_ATOL, rtol=0)


def test_large_round_sharded_equivalence_and_zero_retrace():
    """The headline contract at scale: a 4-way sharded round at M >= 1e5 is
    byte-identical to single-device, and a second same-bucket round builds
    NOTHING (each kernel source builds at most once a process, whatever the
    bucket or the mesh)."""
    mesh = _mesh(4)
    rng = np.random.default_rng(100)
    pol = port_scoring.ScoringPolicy()
    windows, pool = _mk_round(PORT, rng, 1 << 17, 24, n_jobs=101)
    assert len(pool) >= 100_000
    base = port_clearing.clear_round(windows, pool, pol, wis_impl="torch",
                                     device="cpu")
    shard = port_clearing.clear_round(windows, pool, pol, wis_impl="torch",
                                      mesh=mesh)
    assert _sig(base) == _sig(shard)

    # same pow2 bucket, different M / different data -> zero builds
    windows2, pool2 = _mk_round(PORT, rng, (1 << 17) - 4097, 24, n_jobs=101)
    before = (score_ops.build_counts(), wis_ops.build_counts())
    base2 = port_clearing.clear_round(windows2, pool2, pol, wis_impl="torch",
                                      device="cpu")
    shard2 = port_clearing.clear_round(windows2, pool2, pol, wis_impl="torch",
                                       mesh=mesh)
    assert _sig(base2) == _sig(shard2)
    after = (score_ops.build_counts(), wis_ops.build_counts())
    assert after == before, f"rebuilt: {before} -> {after}"
    assert score_ops.bucket_m(len(pool)) == score_ops.bucket_m(len(pool2))


#: the JAX package's sharded rounds on 4 virtual XLA devices; prints one
#: JSON line of (selections, scores, selected_idx) per round
_REF_SHARDED = r"""
import json, sys
import jax
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_sharded_auction as t
from repro.launch.mesh import make_auction_mesh
mesh = make_auction_mesh(4)
assert len(mesh.devices.flat) == 4, jax.devices()
out = []
for seed, spec in json.loads(sys.argv[2]):
    rng, m, n_windows = t._draw(seed)
    windows, pool = t._mk_round(t.REF, rng, m, n_windows)
    rr = t.ref_clearing.clear_round(
        windows, pool, t.ref_scoring.ScoringPolicy(), ages=t.AGES,
        clearing=t._backend(t.REF, tuple(spec)), wis_impl="ref",
        score_impl="ref", mesh=mesh)
    sig = t._sig(rr)
    out.append([sig[0], [float(x) for x in sig[1]], sig[2]])
print(json.dumps(out))
"""


def test_reference_sharded_rounds_match_port_sharded():
    """The JAX package's own 4-device sharded rounds (a subprocess with
    ``JASDA_FORCE_HOST_DEVICES=4``) against the port's 4-shard rounds on
    the same inputs: the same selections, scores within 3e-5."""
    cases = [(1, BACKENDS[0]), (4, BACKENDS[2]), (11, BACKENDS[1])]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]),
               XLA_FLAGS=("--xla_force_host_platform_device_count=4 "
                          + os.environ.get("XLA_FLAGS", "")).strip())
    out = subprocess.run(
        [sys.executable, "-c", _REF_SHARDED, str(ROOT / "tests"),
         json.dumps([[seed, list(spec)] for seed, spec in cases])],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    mesh = _mesh(4)
    for (seed, spec), (sel, scores, idx) in zip(cases, ref):
        rng, m, n_windows = _draw(seed)
        windows, pool = _mk_round(PORT, rng, m, n_windows)
        rr = port_clearing.clear_round(
            windows, pool, port_scoring.ScoringPolicy(), ages=AGES,
            clearing=_backend(PORT, spec), wis_impl="torch",
            score_impl="torch", mesh=mesh)
        got = _sig(rr)
        assert [list(s) for s in got[0]] == sel
        assert [list(i) for i in got[2]] == idx
        np.testing.assert_allclose(np.asarray(got[1]), np.asarray(scores),
                                   atol=SCORE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the two repairs: clear_round on the CPU, meshes refuse to pickle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_clear_round_device_cpu_matches_reference(impl):
    """``clear_round(..., device="cpu")`` runs the device backends on the
    host and equals the reference's "ref" round."""
    windows, pool = _mk_round(PORT, 4, 900, 7)
    rwin, rpool = _mk_round(REF, 4, 900, 7)
    for spec in (BACKENDS[0], BACKENDS[2]):
        got = port_clearing.clear_round(
            windows, pool, port_scoring.ScoringPolicy(), ages=AGES,
            clearing=_backend(PORT, spec), score_impl=impl, wis_impl=impl,
            device="cpu")
        ref = ref_clearing.clear_round(
            rwin, rpool, ref_scoring.ScoringPolicy(), ages=AGES,
            clearing=_backend(REF, spec), score_impl="ref", wis_impl="ref")
        _same_as_reference(got, ref)
        assert sum(len(r.selected) for r in got.results) > 0


def test_meshed_scheduler_refuses_pickle(tmp_path):
    sched = _scheduler(PORT, mesh=_mesh(4), wis_impl="torch",
                       score_impl="torch", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        pickle.dumps(sched)
    store = CheckpointStore(str(tmp_path))
    with pytest.raises(ValueError, match="mesh"):
        store.save_state(1, {"scheduler": sched})
    assert store.latest_step() is None
    plain = _scheduler(PORT, wis_impl="torch", score_impl="torch",
                       device="cpu")
    assert pickle.loads(pickle.dumps(plain)).config.mesh is None


def test_scheduler_device_must_match_mesh():
    with pytest.raises(ValueError, match="mesh"):
        _scheduler(PORT, mesh=_mesh(4), wis_impl="torch", score_impl="torch")
    with pytest.raises(TypeError, match="Mesh"):
        _scheduler(PORT, mesh=object(), device="cpu")
    sched = _scheduler(PORT, mesh=_mesh(4), wis_impl="torch",
                       score_impl="torch", device="cpu")
    assert sched.device == torch.device("cpu")
    assert sched._wis_selector.mesh == _mesh(4)
    assert "bids" in repr(sched._wis_selector)
    # host backends have nothing to shard
    host = make_round_selector("numpy", mesh=_mesh(4))
    assert host.mesh is None
