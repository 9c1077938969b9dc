"""The readers of the program's own spans (``bench/program_spans.py`` and
the metrics on it): on CPU runs with the program's tracer on, each reads a
finite number, the round's four phases add up to the round, and the one
clock offset puts the program's spans onto a trace's clock."""
import math
import sys
import time
import types

import numpy as np
import pytest

from bench import harness, program_spans
from bench.tests.small import run_small

STREAM = ("round_bids_ms", "round_pack_ms", "round_settle_ms",
          "round_commit_ms", "round_wait_ms", "spec_hit_pct",
          "service_host_pct", "gc_pct.round")
PHASES = STREAM[:4]
ENGINE = ("queue_wait_ms", "decode_host_ms", "decode_wait_ms", "pick_ms",
          "gc_pct.serve")


def _read(name, ctx):
    return harness.metric_reader(name).read(ctx)


def test_stream_readers_read_the_rounds_phases():
    from repro_torch.runtime import trace

    with trace.enable():
        result, h = run_small("mig-pod64.stream", seed=2**31 + 23, trace=1)
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert all(math.isfinite(m[name]) for name in STREAM), m
    assert 0.0 <= m["spec_hit_pct"] <= 100.0
    assert 0.0 <= m["service_host_pct"] <= 100.0
    # the four phases cover the benchmark's own round span (its call into
    # the round to the commit), device wait inside them
    phases = sum(m[name] for name in PHASES)
    rounds = h.in_window("round")
    whole = 1e3 * sum(b - a for a, b in rounds) / len(rounds)
    assert abs(phases - whole) <= 0.1 * whole, (phases, whole)
    assert m["round_wait_ms"] < phases


def _engine_run(steps=12):
    """A tiny model served for a fixed number of engine steps with the
    tracer on, its steps and prefills timed as ``bench/drivers/
    engine_chat.py`` times them: a stand-in for the harness."""
    import torch
    from repro_torch.models import Model, ModelConfig
    from repro_torch.runtime import trace
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    kw = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=256, model_axis_size=1)
    model = Model(ModelConfig(**kw, dtype=torch.float32))
    eng = ServingEngine(model, model.init(0, device="cpu"),
                        ServeConfig(batch_slots=2, max_seq=64), device="cpu")
    h = types.SimpleNamespace(spans={"engine_step": [], "prefill": []},
                              t_open=None, t_close=None)
    prefill = eng._prefill_into_slot

    def timed(b, req):
        t0 = time.perf_counter()
        prefill(b, req)
        h.spans["prefill"].append((t0, time.perf_counter()))

    eng._prefill_into_slot = timed
    with trace.enable():
        for i in range(6):
            eng.submit(Request(f"r{i}", (np.arange(5 + i) % 256).astype(np.int32),
                               max_new_tokens=4))
        h.t_open = time.perf_counter()
        for _ in range(steps):
            t0 = time.perf_counter()
            eng.step()
            h.spans["engine_step"].append((t0, time.perf_counter()))
        h.t_close = time.perf_counter()
    return h


def test_engine_readers_read_a_fixed_number_of_steps():
    h = _engine_run()
    ctx = {"h": h, "out": {}, "trace": None}
    got = {name: _read(name, ctx) for name in ENGINE}
    assert all(v is not None and math.isfinite(v) for v in got.values()), got
    assert got["queue_wait_ms"] > 0 and got["decode_host_ms"] > 0
    assert 0.0 <= got["gc_pct.serve"] < 100.0
    assert _read("decode_idle_ms", ctx) is None  # no device trace


def _trace_of(h, offset, busy_share):
    """A trace of ``h``'s stretch on a clock ``offset`` ns ahead, its
    harness ranges copied over and the card busy for the first
    ``busy_share`` of every program ``engine.decode`` span."""
    from repro_torch.runtime import trace

    ranges = [(name, round(a * 1e9) + offset, round(b * 1e9) + offset)
              for name, spans in h.spans.items() for a, b in spans
              if a >= h.t_open]
    kernels = [("k", s.start + offset,
                s.start + offset + int(busy_share * (s.end - s.start)))
               for s in trace.spans("engine.decode")
               if s.start >= h.t_open * 1e9]
    return harness.Trace(kernels, ranges, int(h.t_open * 1e9) + offset,
                         int(h.t_close * 1e9) + offset)


def test_one_offset_puts_the_program_on_the_trace_clock():
    from repro_torch.runtime import trace

    h = _engine_run()
    off = 1_792_313_477_000_000_000 - int(h.t_open * 1e9)
    tr = _trace_of(h, off, 0.25)
    got = program_spans.clock_offset(h, tr, ("engine_step", "prefill"))
    assert got == off
    decode = [s for s in trace.spans("engine.decode")
              if s.start >= h.t_open * 1e9]
    steps = len([s for s in trace.spans("engine.logits")
                 if s.start >= h.t_open * 1e9])
    want = 1e3 * sum(s.end - s.start - int(0.25 * (s.end - s.start))
                     for s in decode) / 1e9 / steps
    idle = _read("decode_idle_ms", {"h": h, "out": {}, "trace": tr})
    assert idle == pytest.approx(want, rel=1e-6)
    # a range with no span of its own (a round that announced no window)
    # pairs with none
    name, a, b = tr.ranges[3]
    tr.ranges.insert(3, (name, (a + tr.ranges[2][2]) // 2, (a + tr.ranges[2][2]) // 2 + 10))
    assert program_spans.clock_offset(h, tr, ("engine_step", "prefill")) == off
    del tr.ranges[3]
    # ranges that do not pair with their spans in length: no offset
    tr.ranges[:] = [(name, a, b + 2_000_000) for name, a, b in tr.ranges]
    assert program_spans.clock_offset(h, tr, ("engine_step",)) is None
    assert program_spans.clock_offset(h, None, ("engine_step",)) is None


def test_idle_gaps_are_named_by_the_innermost_program_span():
    from repro_torch.runtime.trace import Span

    def span(name, a, b, parent=None):
        s = Span(name, a, parent, {})
        s.end = b
        return s

    outer = span("service.round", 100, 800)
    spans = [outer, span("round.pack", 200, 400, outer),
             span("device.wait", 300, 350)]
    off = 1000
    # busy: [1000, 1150), [1320, 1340), [1600, 1700) on the trace's clock
    tr = harness.Trace([("k", 1000, 1150), ("k", 1320, 1340),
                        ("k", 1600, 1700)], [], 1000, 2000)
    gaps = program_spans.idle_gaps(tr, spans, off)
    # gaps: [1150, 1320) mid 1235 -> round.pack; [1340, 1600) mid 1470 ->
    # service.round; [1700, 2000) mid 1850 -> outside
    assert gaps == [("outside every span", 300e-9),
                    ("service.round", 260e-9), ("round.pack", 170e-9)]
    assert sum(s for _, s in gaps) == pytest.approx((2000 - 1000 - 270) / 1e9)


def test_readers_give_nothing_without_the_program_tracer(monkeypatch):
    import repro_torch.runtime as runtime

    h = types.SimpleNamespace(spans={}, t_open=1.0, t_close=2.0)
    monkeypatch.delattr(runtime, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    ctx = {"h": h, "out": {}, "trace": None}
    for name in STREAM + ENGINE + ("decode_idle_ms",):
        assert _read(name, ctx) is None
