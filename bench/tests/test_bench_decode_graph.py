"""``decode_graph_pct``: the share of the window's ``engine.decode`` spans
whose ``graph`` attribute reads ``replay``, read from fixed span lists (no
timed window), and nothing where no span carries the attribute."""
import types

import pytest

from bench import harness

S = 1_000_000_000  # ns a second


def _read(monkeypatch, spans):
    from repro_torch.runtime import trace

    monkeypatch.setattr(trace, "spans", lambda name=None: list(spans))
    h = types.SimpleNamespace(t_open=10.0, t_close=20.0)
    return harness.metric_reader("decode_graph_pct").read(
        {"h": h, "out": {}, "trace": None})


def _decode(at, **attrs):
    from repro_torch.runtime import trace

    s = trace.Span("engine.decode", int(at * S), None, dict(slots=4, **attrs))
    s.end = s.start + S // 100
    return s


def _other(name, at):
    from repro_torch.runtime import trace

    s = trace.Span(name, int(at * S), None, {})
    s.end = s.start + S // 100
    return s


@pytest.mark.parametrize("hows,want", [
    (["replay"] * 20, 100.0),
    (["eager"] * 20, 0.0),
    (["capture"] + ["eager"] * 3, 0.0),
    (["capture"] + ["replay"] * 3, 75.0),
    (["replay", "eager", "replay", "eager", "replay"], 60.0),
])
def test_share_of_replayed_steps(monkeypatch, hows, want):
    spans = [_decode(11 + 0.1 * i, graph=how) for i, how in enumerate(hows)]
    spans += [_other("engine.logits", 11.05), _other("engine.pick", 11.06)]
    assert _read(monkeypatch, spans) == pytest.approx(want)


def test_spans_outside_the_window_do_not_count(monkeypatch):
    spans = [_decode(5, graph="capture"), _decode(12, graph="replay"),
             _decode(13, graph="replay"), _decode(25, graph="eager")]
    assert _read(monkeypatch, spans) == 100.0


@pytest.mark.parametrize("spans", [
    [],  # no spans: a program without the tracer, or tracing off
    [_decode(12), _decode(13)],  # a program whose decode spans lack it
    [_other("engine.logits", 12)],
])
def test_nothing_to_read(monkeypatch, spans):
    assert _read(monkeypatch, spans) is None
