"""The program's own spans (``repro_torch.runtime.trace``) as the per-layer
readers take them, and the one clock they share with the profiler's trace.

The program records spans while a ``torch.profiler`` records (a ``--trace
1`` run's traced stretch) or while ``trace.enable()`` holds, on
``time.perf_counter_ns()``: the harness's clock, so its window cuts them
directly.  A program without the tracer gives nothing to read, and every
function here then returns None.

The profiler's trace keeps its own clock.  :func:`clock_offset` maps the
program's nanoseconds onto it by one offset, taken from the harness's
spans that both clocks hold (``h.spans`` and ``Trace.ranges``);
:func:`idle_gaps` then names each device-idle gap by the program span it
fell in.
"""
from __future__ import annotations

import bisect
import statistics
from typing import Iterable, List, Optional, Tuple

#: largest gap (ns) between a harness span's length on the two clocks
SAME_SPAN_NS = 1_000_000


def kept(h) -> Optional[list]:
    """The program's spans that overlap the window (``Span`` objects), or
    None where the program keeps none."""
    try:
        from repro_torch.runtime import trace
    except ImportError:  # a program without the tracer
        return None
    if h.t_open is None or h.t_close is None:
        return None
    a, b = h.t_open * 1e9, h.t_close * 1e9
    out = [s for s in trace.spans() if s.end > a and s.start < b]
    return out or None


def stretch(h, spans) -> Tuple[float, float]:
    """The part of the window in which the program kept spans (ns): a
    traced run turns them on for its traced stretch alone."""
    a, b = h.t_open * 1e9, h.t_close * 1e9
    return (max(a, min(s.start for s in spans)),
            min(b, max(s.end for s in spans)))


def seconds(spans, name: str, lo: float, hi: float) -> float:
    """Summed seconds of the spans ``name``, each cut to [lo, hi]."""
    return sum(max(0.0, min(s.end, hi) - max(s.start, lo))
               for s in spans if s.name == name) / 1e9


def rounds(spans) -> int:
    """Rounds settled: the distinct ``now`` of the ``round.settle`` spans."""
    return len({s.attrs["now"] for s in spans if s.name == "round.settle"})


def steps(spans) -> int:
    """Engine decode steps: the ``engine.logits`` spans."""
    return sum(1 for s in spans if s.name == "engine.logits")


def per_unit_ms(ctx, name: str, unit) -> Optional[float]:
    """Milliseconds of span ``name`` in the window per round or per step
    (``unit`` is :func:`rounds` or :func:`steps`)."""
    h = ctx["h"]
    spans = kept(h)
    if spans is None:
        return None
    n = unit(spans)
    if not n:
        return None
    lo, hi = stretch(h, spans)
    return 1e3 * seconds(spans, name, lo, hi) / n


def share_pct(ctx, name: str, less: str = None) -> Optional[float]:
    """Share (%) of the traced stretch inside spans ``name``, less the part
    inside their ``less`` spans (0 where the stretch holds none)."""
    h = ctx["h"]
    spans = kept(h)
    if spans is None:
        return None
    lo, hi = stretch(h, spans)
    inside = seconds(spans, name, lo, hi)
    if less is not None:
        inside -= seconds(spans, less, lo, hi)
    return 100.0 * inside / ((hi - lo) / 1e9)


def _pairs(host, prof, offset: int) -> List[int]:
    """Start differences of the ranges ``prof`` that pair under ``offset``:
    each with the span of ``host`` that starts nearest it, of those whose
    start and length agree with it within ``SAME_SPAN_NS``."""
    starts = [a for a, _ in host]
    out = []
    for c, d in prof:
        lo = bisect.bisect_left(starts, c - offset - SAME_SPAN_NS)
        hi = bisect.bisect_right(starts, c - offset + SAME_SPAN_NS)
        fits = [(abs(a + offset - c), c - a) for a, b in host[lo:hi]
                if abs((b - a) - (d - c)) <= SAME_SPAN_NS]
        if fits:
            out.append(min(fits)[1])
    return out


def clock_offset(h, trace, names: Iterable[str]) -> Optional[int]:
    """Nanoseconds to add to a program time to put it on ``trace``'s clock:
    the median start difference of the harness's spans ``names`` of the
    traced stretch that both clocks hold (its ``h.spans`` from the window's
    start, its ``trace.ranges``).  A first offset is the one, of the first
    ranges' and spans' start differences, under which most of the first
    ranges pair (:func:`_pairs`); a range with no span of its own (a round
    that announced no window) pairs with none.  None where less than half
    the ranges pair."""
    if trace is None:
        return None
    diffs, ranges = [], 0
    for name in names:
        host = sorted((round(a * 1e9), round(b * 1e9))
                      for a, b in h.spans.get(name, ()) if a >= h.t_open)
        prof = sorted(trace.spans(name))
        ranges += len(prof)
        guesses = {c - a for a, _ in host[:16] for c, _ in prof[:16]}
        if guesses:
            guess = max(sorted(guesses),
                        key=lambda g: len(_pairs(host, prof[:32], g)))
            diffs += _pairs(host, prof, guess)
    if not diffs or 2 * len(diffs) < ranges:
        return None
    return statistics.median_low(diffs)


def idle_gaps(trace, spans, offset: int) -> List[Tuple[str, float]]:
    """Every device-idle gap of the traced stretch, longest first, as
    ``(name, seconds)``: the innermost program span (the shortest) that
    covers the gap's midpoint, or ``"outside every span"``."""
    busy = trace._merge([(a, b) for _, a, b in trace.kernels])
    gaps, edge = [], trace.t0
    for a, b in [(max(a, trace.t0), min(b, trace.t1)) for a, b in busy
                 if b > trace.t0 and a < trace.t1] + [(trace.t1, trace.t1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if not gaps:
        return []
    mids = sorted(((a + b) / 2, k) for k, (a, b) in enumerate(gaps))
    keys = [m for m, _ in mids]
    names = ["outside every span"] * len(gaps)
    # longest first, so that a shorter span inside it names its gaps
    for s in sorted(spans, key=lambda s: s.start - s.end):
        lo = bisect.bisect_left(keys, s.start + offset)
        hi = bisect.bisect_right(keys, s.end + offset)
        for _, k in mids[lo:hi]:
            names[k] = s.name
    out = [(names[k], (b - a) / 1e9) for k, (a, b) in enumerate(gaps)]
    return sorted(out, key=lambda g: -g[1])

