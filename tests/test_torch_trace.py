"""The port's tracer (``repro_torch.runtime.trace``): off it records
nothing and hands out one shared no-op; on it nests spans, tags a round's
spans with its ``now`` and a request's with its ``request_id``, follows a
recording ``torch.profiler``, times the cyclic collector, and leaves every
selection, commit and feedback of a seeded run as it was."""
import collections
import gc
import pickle

import numpy as np
import pytest
import torch

from repro_torch.core import JasdaScheduler, SliceSpec
from repro_torch.core.pipeline import RoundPipeline
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.simulator import make_workload
from repro_torch.models import Model, ModelConfig
from repro_torch.runtime import trace
from repro_torch.serving import Request, ServeConfig, ServingEngine

GB = 1 << 30
ROUND_SPANS = ("round.bids", "round.pack", "round.settle", "round.commit")


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def test_off_records_nothing_and_shares_one_noop():
    assert not trace.enabled()
    a, b = trace.span("x"), trace.span("y", now=1.0)
    assert a is b
    with a as sp:
        assert sp is None
    assert trace.stamp() is None
    trace.record("z", 5)
    assert trace.spans() == [] and trace.dropped() == 0
    assert trace._on_gc not in gc.callbacks


def test_spans_nest_with_their_parents():
    with trace.enable():
        assert trace.enabled()
        with trace.span("outer", now=3.0) as outer:
            with trace.span("inner") as inner:
                pass
            with trace.span("second"):
                pass
        t = trace.stamp()
        trace.record("later", t, request_id="r1")
    assert not trace.enabled()
    got = trace.spans()
    assert [s.name for s in got] == ["outer", "inner", "second", "later"]
    assert inner.parent is outer and got[2].parent is outer
    assert outer.parent is None and got[3].parent is None
    assert outer.attrs == {"now": 3.0} and got[3].attrs == {"request_id": "r1"}
    assert all(s.start <= s.end for s in got)
    assert outer.start <= inner.start and inner.end <= outer.end
    assert [s.name for s in trace.spans("inner")] == ["inner"]


def test_enable_nests_and_a_raising_block_still_closes():
    with trace.enable():
        with trace.enable():
            pass
        assert trace.enabled()
        with pytest.raises(ValueError):
            with trace.span("boom"):
                raise ValueError
        with trace.span("after") as after:
            pass
    assert after.parent is None
    assert [s.name for s in trace.spans()] == ["boom", "after"]


def test_full_buffer_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(trace._state, "buf", collections.deque(maxlen=3))
    with trace.enable():
        for k in range(5):
            with trace.span(f"s{k}"):
                pass
    assert [s.name for s in trace.spans()] == ["s2", "s3", "s4"]
    assert trace.dropped() == 2
    trace.reset()
    assert trace.dropped() == 0


def test_a_recording_profiler_turns_tracing_on():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.enabled()
        with trace.span("round.pack", now=1.0):
            torch.ones(4).add_(1)
    assert not trace.enabled()
    assert [s.name for s in trace.spans()] == ["round.pack"]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "round.pack" in names
    # off again: no record_function, no span
    with trace.span("round.pack"):
        pass
    assert len(trace.spans()) == 1


def test_collector_pauses_are_spans_while_on():
    with trace.enable():
        with trace.span("work") as work:
            gc.collect()
    pauses = trace.spans("gc")
    assert pauses and pauses[0].attrs == {"generation": 2}
    assert pauses[0].parent is work
    assert trace._on_gc not in gc.callbacks
    gc.collect()
    assert len(trace.spans("gc")) == len(pauses)


def _sched(**kw):
    sched = JasdaScheduler(
        [SliceSpec("s20", 20 * GB, n_chips=4),
         SliceSpec("s10", 10 * GB, n_chips=2),
         SliceSpec("s5", 5 * GB)],
        SchedulerConfig(score_impl="torch", wis_impl="torch", device="cpu",
                        **kw))
    for a in make_workload(18, seed=3, arrival_rate=2.0):
        sched.add_job(a, 0.0)
    return sched


def _run(pipelined: bool):
    """Selections, commit log and each round's feedback (pickled) of a
    seeded run of 30 rounds."""
    sched = _sched()
    pipe = RoundPipeline(sched) if pipelined else None
    picks, feedback = [], []
    for t in range(30):
        if pipe is None:
            rr = sched.run_round(float(t))
        else:
            rr = pipe.tick(float(t), next_time=float(t + 1) if t < 29 else None)
        picks.append(None if rr is None else [v.variant_id for v in rr.selected])
        feedback.append(pickle.dumps(sched.last_feedback))
    if pipe is not None:
        pipe.flush()
    log = [(r.variant_id, r.job_id, r.slice_id, r.t_start, r.t_end,
            r.commit_time, r.score, r.status) for r in sched.commit_log]
    return picks, log, feedback, pipe


@pytest.mark.parametrize("pipelined", [False, True], ids=["serial", "pipelined"])
def test_tracing_leaves_a_seeded_run_byte_identical(pipelined):
    off = _run(pipelined)[:3]
    with trace.enable():
        on = _run(pipelined)
    assert on[:3] == off
    assert any(p for p in off[0]) and trace.spans("round.settle")
    if pipelined:
        preps = collections.Counter(s.attrs["prep"]
                                    for s in trace.spans("round.settle"))
        stats = on[3].stats
        assert set(preps) <= {"hit", "filtered", "discarded", "serial"}
        assert preps["discarded"] > 0 and preps["serial"] > 0
        # rounds that announced no window settle without a span
        assert preps["hit"] <= stats["spec_hit"]
        assert preps["filtered"] <= stats["spec_filtered"]
        assert (preps["serial"] + preps["discarded"]
                <= stats["serial_prep"])
        assert preps["discarded"] <= stats["spec_discarded"]


def test_every_span_of_a_round_carries_its_now():
    with trace.enable():
        sched = _sched()
        sched.run_rounds_pipelined([float(t) for t in range(12)])
    spans = trace.spans()
    rounds = [s for s in spans if s.name in ROUND_SPANS]
    assert {s.name for s in rounds} == set(ROUND_SPANS)
    assert all(isinstance(s.attrs["now"], float) for s in rounds)
    settled = {s.attrs["now"] for s in trace.spans("round.settle")}
    assert settled == {row.t for row in sched.log if row.n_windows}
    # the phases of a round do not nest in one another
    assert all(s.parent is None for s in rounds)
    # a host wait on the card lies inside a round's packing or settle
    waits = trace.spans("device.wait")
    assert waits and all(w.parent.name in ("round.pack", "round.settle")
                         and "now" in w.parent.attrs for w in waits)
    packs = trace.spans("round.pack")
    assert all(s.attrs["bids"] >= 0 and s.attrs["windows"] > 0 for s in packs)
    assert any(s.attrs["speculative"] for s in packs)


def test_every_span_of_a_request_carries_its_id():
    kw = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=256, model_axis_size=1)
    model = Model(ModelConfig(**kw, dtype=torch.float32))
    params = model.init(0, device="cpu")
    eng = ServingEngine(model, params, ServeConfig(batch_slots=2, max_seq=64),
                        device="cpu")
    reqs = [Request(f"r{i}", (np.arange(4 + i) % 256).astype(np.int32),
                    max_new_tokens=5) for i in range(5)]
    with trace.enable():
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
    ids = [r.request_id for r in reqs]
    for name in ("request.queued", "engine.prefill"):
        assert sorted(s.attrs["request_id"] for s in trace.spans(name)) == ids
    queued = {s.attrs["request_id"]: s for s in trace.spans("request.queued")}
    prefill = {s.attrs["request_id"]: s for s in trace.spans("engine.prefill")}
    assert all(queued[i].end <= prefill[i].start for i in ids)
    steps = len(trace.spans("engine.logits"))
    assert steps > 0
    assert len(trace.spans("engine.decode")) == len(trace.spans("engine.pick")) == steps
    assert not eng._queued_at
