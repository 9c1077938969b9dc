"""Crash checkpoints: the port's store against ``repro.checkpoint``.

The array path writes the reference's on-disk format: a tree saved by
either store restores bit for bit through the other (bfloat16 and float8
leaves as raw bits under their logical dtype name), and the port's
flatten visits leaves in JAX's pytree order.  The pickle path, ``latest``,
the GC and the typed ``CheckpointError`` behave as the reference's.  The
simulator's ``scheduler_crash`` path restores through the ported store and
replays byte-identically to the uncrashed run, serial and pipelined, and
to the reference's run of the same plan.
"""
import collections
import json
import os
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointError as RefCheckpointError
from repro.checkpoint import CheckpointStore as RefStore
from repro.core import FaultEvent as RefFaultEvent
from repro.core import FaultPlan as RefFaultPlan
from repro.core import JasdaScheduler as RefScheduler
from repro.core import SimConfig as RefSimConfig
from repro.core import SliceSpec as RefSliceSpec
from repro.core import make_workload as ref_make_workload
from repro.core import simulate as ref_simulate
from repro.core.scheduler import SchedulerConfig as RefSchedulerConfig
from repro_torch.checkpoint import CheckpointError, CheckpointStore
from repro_torch.checkpoint.store import tree_flatten
from repro_torch.core import (FaultEvent, FaultPlan, JasdaScheduler, SimConfig,
                              SliceSpec, make_workload, simulate)
from repro_torch.core.faults import (SCHEDULER_CRASH, SLICE_REVOKED,
                                     AGENT_SILENT)
from repro_torch.core.scheduler import SchedulerConfig

GB = 1 << 30
SCORE_ATOL = 3e-5

Pair = collections.namedtuple("Pair", "lo hi")


def _trees():
    """Seeded trees of every container kind the flatten must order."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    bf = rng.standard_normal((5,)).astype(np.float32)
    return {
        "nested": {"b": {"z": f32, "a": bf}, "a": [np.arange(4, dtype=np.int32),
                                                  (bf[:2], None, f32[0])]},
        "sequence": [f32, (bf, [np.int64(7)], None)],
        "namedtuple": {"p": Pair(lo=f32[:1], hi=bf), "q": None},
        "ordered": collections.OrderedDict([("y", bf), ("x", f32)]),
        "leaf": f32,
    }


@pytest.mark.parametrize("name", sorted(_trees()))
def test_flatten_matches_jax_leaf_order(name):
    tree = _trees()[name]
    ref_leaves, ref_def = jax.tree.flatten(tree)
    leaves, unflatten = tree_flatten(tree)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert a is b
    # unflatten rebuilds JAX's structure around new leaves
    marks = list(range(len(leaves)))
    assert (jax.tree.structure(unflatten(marks))
            == jax.tree.structure(jax.tree.unflatten(ref_def, marks)))


def _jax_tree():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    return {
        "w": jnp.asarray(w),
        "layers": [{"bf": jnp.asarray(w[1], jnp.bfloat16),
                    "f8": jnp.asarray(w[2] / 4, jnp.float8_e4m3fn),
                    "f8b": jnp.asarray(w[3] / 4, jnp.float8_e5m2)},
                   {"i": jnp.arange(5, dtype=jnp.int32), "none": None}],
        "step": jnp.asarray(3, jnp.int32),
    }


def _torch_tree(tree):
    """The same tree with torch leaves (bits carried, never re-rounded)."""
    def conv(x):
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        if a.dtype == ml_dtypes.float8_e4m3fn:
            return torch.from_numpy(a.view(np.uint8).copy()).view(
                torch.float8_e4m3fn)
        if a.dtype == ml_dtypes.float8_e5m2:
            return torch.from_numpy(a.view(np.uint8).copy()).view(
                torch.float8_e5m2)
        return torch.from_numpy(a.copy())
    return jax.tree.map(conv, tree)


def _bits(x):
    """Raw bytes and dtype name of a jax, numpy or torch leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        name = str(x.dtype).replace("torch.", "")
        width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
        return name, tuple(x.shape), x.view(width[x.element_size()]).numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def test_reference_checkpoint_restores_bit_equal_in_port(tmp_path):
    tree = _jax_tree()
    RefStore(str(tmp_path)).save(7, tree, blocking=True)
    template = _torch_tree(jax.tree.map(jnp.zeros_like, tree))
    restored, step = CheckpointStore(str(tmp_path)).restore(template)
    assert step == 7
    got = [_bits(x) for x in tree_flatten(restored)[0]]
    want = [_bits(x) for x in jax.tree.leaves(tree)]
    assert got == want
    assert restored["layers"][1]["none"] is None
    assert restored["layers"][0]["bf"].dtype == torch.bfloat16


def test_port_checkpoint_restores_bit_equal_in_reference(tmp_path):
    tree = _jax_tree()
    CheckpointStore(str(tmp_path)).save(4, _torch_tree(tree), blocking=True)
    template = jax.tree.map(jnp.zeros_like, tree)
    restored, step = RefStore(str(tmp_path)).restore(template)
    assert step == 4
    assert ([_bits(x) for x in jax.tree.leaves(restored)]
            == [_bits(x) for x in jax.tree.leaves(tree)])


def test_manifests_agree_but_for_the_treedef_string(tmp_path):
    tree = _jax_tree()
    RefStore(str(tmp_path / "ref")).save(1, tree, blocking=True)
    CheckpointStore(str(tmp_path / "port")).save(1, _torch_tree(tree),
                                                 blocking=True)
    ref = json.loads((tmp_path / "ref" / "step_1" / "manifest.json").read_text())
    port = json.loads((tmp_path / "port" / "step_1" / "manifest.json").read_text())
    ref.pop("treedef")
    port.pop("treedef")
    assert port == ref
    assert "bfloat16" in ref["dtypes"] and "float8_e5m2" in ref["dtypes"]
    a = np.load(tmp_path / "ref" / "step_1" / "shard_0.npz")
    b = np.load(tmp_path / "port" / "step_1" / "shard_0.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_restore_casts_to_template_dtype_and_device(tmp_path):
    tree = _jax_tree()
    RefStore(str(tmp_path)).save(2, tree, blocking=True)
    ref_template = jax.tree.map(lambda x: jnp.zeros_like(x, jnp.float32), tree)
    ref_out, _ = RefStore(str(tmp_path)).restore(ref_template)
    # float32 torch leaves on the CPU device, and plain numpy leaves
    port_template = jax.tree.map(lambda x: torch.zeros(x.shape), tree)
    port_out, _ = CheckpointStore(str(tmp_path)).restore(port_template)
    np_template = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), tree)
    np_out, _ = CheckpointStore(str(tmp_path)).restore(np_template)
    for r, p, n in zip(jax.tree.leaves(ref_out), tree_flatten(port_out)[0],
                       tree_flatten(np_out)[0]):
        assert p.dtype == torch.float32 and p.device.type == "cpu"
        assert isinstance(n, np.ndarray) and n.dtype == np.float32
        assert _bits(p)[2] == _bits(np.asarray(r))[2] == _bits(n)[2]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_array_roundtrip_latest_and_gc(pkg, tmp_path):
    """The reference's own roundtrip test, through each store, both giving
    the same steps and values."""
    store = (RefStore if pkg == "ref" else CheckpointStore)(str(tmp_path), keep=2)
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones((4,), np.float32)}}
    if pkg == "port":
        tree = {"a": torch.from_numpy(tree["a"]),
                "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    else:
        tree = {"a": jnp.asarray(tree["a"]),
                "b": {"c": jnp.ones((4,), jnp.bfloat16)}}
    for step in (10, 20, 30):
        store.save(step, tree, blocking=True)
    assert store.latest_step() == 30
    assert store.steps() == [20, 30]
    restored, step = store.restore(tree)
    assert step == 30
    assert [_bits(x) for x in jax.tree.leaves(tree)] == \
        [_bits(x) for x in jax.tree.leaves(restored)]
    # a torn write of a newer step stays invisible
    os.makedirs(tmp_path / "step_90.tmp")
    assert store.latest_step() == 30
    # an array step is refused by the pickle path
    with pytest.raises(ValueError):
        store.restore_state(30)


def test_template_mismatch_raises(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"a": torch.zeros(2), "b": torch.ones(3)}, blocking=True)
    with pytest.raises(ValueError, match="mismatch"):
        store.restore({"a": torch.zeros(2)})


def test_async_save_joins_before_the_next(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=5)
    for step in range(3):
        store.save(step, {"x": torch.full((64,), float(step))})
    store.wait()
    assert store.steps() == [0, 1, 2]
    out, _ = store.restore({"x": torch.zeros(64)})
    assert torch.equal(out["x"], torch.full((64,), 2.0))


def _state_ops(store_cls, error_cls, root):
    """The reference's save_state scenarios; returns what each observed."""
    seen = []
    store = store_cls(str(root / "gc"), keep=2)
    for s in range(6):
        store.save_state(s, {"s": s, "a": np.arange(s)})
    obj, step = store.restore_state()
    seen.append((store.steps(), obj["s"], step, obj["a"].tolist()))

    store = store_cls(str(root / "trunc"))
    store.save_state(3, {"x": list(range(1000))})
    blob = root / "trunc" / "step_3" / "state.pkl"
    blob.write_bytes(blob.read_bytes()[:20])
    with pytest.raises(error_cls):
        store.restore_state(3)

    store = store_cls(str(root / "corrupt"))
    store.save_state(1, {"x": 1})
    blob = root / "corrupt" / "step_1" / "state.pkl"
    data = bytearray(blob.read_bytes())
    data[: len(data) // 2] = bytes(range(len(data) // 2))
    blob.write_bytes(bytes(data))
    with pytest.raises(Exception) as ei:
        store.restore_state(1)
    assert not isinstance(ei.value, (EOFError, pickle.UnpicklingError))
    seen.append(type(ei.value).__name__)

    store = store_cls(str(root / "fallback"), keep=5)
    store.save_state(1, {"ok": 1})
    store.save_state(2, {"ok": 2})
    (root / "fallback" / "step_2" / "state.pkl").write_bytes(b"\x80garbage")
    with pytest.raises(error_cls):
        store.restore_state()
    obj, step = store.restore_state(1)
    seen.append((obj["ok"], step))
    with pytest.raises(FileNotFoundError):
        store_cls(str(root / "empty")).restore_state()
    return seen


def test_state_path_behaves_as_the_reference(tmp_path):
    ref = _state_ops(RefStore, RefCheckpointError, tmp_path / "ref")
    port = _state_ops(CheckpointStore, CheckpointError, tmp_path / "port")
    assert port == ref
    assert ref[0] == ([4, 5], 5, 5, [0, 1, 2, 3, 4])


def test_pickle_checkpoints_cross_both_stores(tmp_path):
    state = {"round": 12, "rows": [("a", 1.5), ("b", 2.5)]}
    CheckpointStore(str(tmp_path / "p")).save_state(12, state)
    assert RefStore(str(tmp_path / "p")).restore_state() == (state, 12)
    RefStore(str(tmp_path / "r")).save_state(5, state)
    assert CheckpointStore(str(tmp_path / "r")).restore_state() == (state, 5)


# ---------------------------------------------------------------------------
# the simulator's crash path through the ported store
# ---------------------------------------------------------------------------

def _slices(spec_cls, n=3, cap_gb=16):
    return [spec_cls(f"S{k}", cap_gb * GB, flops_per_s=1.0, hbm_bw=1.0)
            for k in range(n)]


def _commit_rows(sched):
    return [(r.status, r.job_id, r.slice_id, r.t_start, r.t_end)
            for r in sched.commit_log]


def _log_rows(sched):
    return [(l.t, l.n_bidders, l.n_bids, l.n_selected, l.n_windows,
             l.n_conflicts, l.n_dropped) for l in sched.log]


def _key(r):
    return (_commit_rows(r.scheduler), _log_rows(r.scheduler),
            r.jct_per_job, r.calibration, r.n_finished, r.summary())


def _scores(r):
    return np.array([row.score for row in r.scheduler.commit_log])


_CRASH_BASE = ((12.0, SLICE_REVOKED, "S1", 40.0),
               (30.0, AGENT_SILENT, "J003", 20.0))
_CRASHES = ((40.5, SCHEDULER_CRASH, None, 0.0),
            (90.5, SCHEDULER_CRASH, None, 0.0))


def _plan(event_cls, plan_cls, crash):
    events = _CRASH_BASE + (_CRASHES if crash else ())
    return plan_cls(seed=7, events=tuple(
        event_cls(t=t, kind=k, target=tg, duration=d) for t, k, tg, d in events))


def _run_port(impl, pipeline, crash, root, n_jobs=8):
    store = CheckpointStore(str(root / f"port_{impl}_{pipeline}_{crash}"))
    sched = JasdaScheduler(_slices(SliceSpec), SchedulerConfig(
        score_impl=impl, wis_impl=impl, device="cpu"))
    return simulate(sched, make_workload(n_jobs, seed=3),
                    SimConfig(t_end=300.0, seed=1, pipeline=pipeline),
                    faults=_plan(FaultEvent, FaultPlan, crash),
                    checkpoint=store, checkpoint_every=5)


def _run_ref(impl, pipeline, crash, root, n_jobs=8):
    store = RefStore(str(root / f"ref_{impl}_{pipeline}_{crash}"))
    sched = RefScheduler(_slices(RefSliceSpec), RefSchedulerConfig(
        score_impl=impl, wis_impl=impl))
    return ref_simulate(sched, ref_make_workload(n_jobs, seed=3),
                        RefSimConfig(t_end=300.0, seed=1, pipeline=pipeline),
                        faults=_plan(RefFaultEvent, RefFaultPlan, crash),
                        checkpoint=store, checkpoint_every=5)


@pytest.mark.parametrize("pipeline", [False, True])
def test_crash_replay_is_byte_identical(pipeline, tmp_path):
    clean = _run_port("numpy", pipeline, False, tmp_path)
    crash = _run_port("numpy", pipeline, True, tmp_path)
    ref = _run_ref("numpy", pipeline, True, tmp_path)
    assert len(_commit_rows(clean.scheduler)) > 5
    assert _key(crash) == _key(clean) == _key(ref)
    assert crash.total_score == clean.total_score == ref.total_score


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_crash_replay_through_device_backends(impl, tmp_path):
    """The device backends forced on both sides (the port's plain versions
    on the CPU, the reference's jnp oracle), the scheduler crashing twice."""
    crash = _run_port(impl, True, True, tmp_path, n_jobs=12)
    clean = _run_port(impl, False, False, tmp_path, n_jobs=12)
    ref = _run_ref("ref", True, True, tmp_path, n_jobs=12)
    assert len(_commit_rows(clean.scheduler)) > 5
    assert _key(crash) == _key(clean) == _key(ref)
    np.testing.assert_allclose(_scores(crash), _scores(ref), atol=SCORE_ATOL,
                               rtol=0)
    assert crash.scheduler.backend_health.failed_backends() == {}


def test_crash_without_checkpoint_is_ignored():
    plan = FaultPlan(seed=0, events=(FaultEvent(t=50.5, kind=SCHEDULER_CRASH),))
    cfg = SchedulerConfig(device="cpu")
    r = simulate(JasdaScheduler(_slices(SliceSpec), cfg),
                 make_workload(6, seed=3), SimConfig(t_end=300.0, seed=1),
                 faults=plan)
    r_ref = ref_simulate(RefScheduler(_slices(RefSliceSpec)),
                         ref_make_workload(6, seed=3),
                         RefSimConfig(t_end=300.0, seed=1))
    assert r.jct_per_job == r_ref.jct_per_job


def test_scheduler_pickle_preserves_commit_identity():
    sched = JasdaScheduler(_slices(SliceSpec), SchedulerConfig(
        score_impl="torch", wis_impl="torch", device="cpu"))
    for a in make_workload(6, seed=3):
        sched.add_job(a, 0.0)
    for k in range(10):
        sched.run_round(float(k))
    assert sched.commitments
    s2 = pickle.loads(pickle.dumps(sched))
    assert _commit_rows(s2) == _commit_rows(sched)
    for c in s2.commitments:
        entry_c, _rec = s2._commit_index[id(c.variant)]
        assert entry_c is c
    # the restored scheduler keeps its device and keeps scheduling alike
    assert s2.device == sched.device
    a, b = sched.run_round(10.0), s2.run_round(10.0)
    assert [v.variant_id for v in a.selected] == [v.variant_id for v in b.selected]


def test_chaos_seeded_plan_matches_reference(tmp_path):
    """A generated plan (revocations, silent and erroring bidders, a crash
    mid-run): pipelined equals serial, and both equal the reference."""
    t_end = 400.0
    kw = dict(t_end=t_end, slice_ids=[f"S{k}" for k in range(3)],
              job_ids=[f"J{i:03d}" for i in range(10)], revoke_rate=0.004,
              silent_rate=0.003, error_rate=0.003, repair_time=40.0,
              fault_duration=15.0, crash_times=(t_end / 2 + 0.5,))
    results = {}
    for pipeline in (False, True):
        store = CheckpointStore(str(tmp_path / f"chaos_{pipeline}"))
        r = simulate(JasdaScheduler(_slices(SliceSpec),
                                    SchedulerConfig(device="cpu")),
                     make_workload(10, seed=1),
                     SimConfig(t_end=t_end, seed=2, pipeline=pipeline),
                     faults=FaultPlan.generate(0, **kw), checkpoint=store,
                     checkpoint_every=20)
        assert r.iterations >= int(t_end) - 1
        assert any(row.status == "lost" for row in r.scheduler.commit_log)
        results[pipeline] = _key(r)
    ref = ref_simulate(RefScheduler(_slices(RefSliceSpec)),
                       ref_make_workload(10, seed=1),
                       RefSimConfig(t_end=t_end, seed=2, pipeline=True),
                       faults=RefFaultPlan.generate(0, **kw),
                       checkpoint=RefStore(str(tmp_path / "chaos_ref")),
                       checkpoint_every=20)
    assert results[False] == results[True] == _key(ref)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_checkpoint_ignores_partial_writes(pkg, tmp_path):
    """``tests/test_training_substrate.py``'s test through each store: a
    torn write of a newer step (its ``.tmp`` directory) stays invisible,
    for the array path and the pickle path."""
    store = (RefStore if pkg == "ref" else CheckpointStore)(str(tmp_path))
    zeros = jnp.zeros(3) if pkg == "ref" else torch.zeros(3)
    store.save(5, {"x": zeros}, blocking=True)
    os.makedirs(tmp_path / "step_9.tmp")
    assert store.latest_step() == 5
    store.save_state(7, {"t": 7.0})
    os.makedirs(tmp_path / "step_11.tmp")
    assert store.latest_step() == 7
    assert store.restore_state() == ({"t": 7.0}, 7)
