"""Device: the card's idle time inside the program's ``engine.decode``
spans (the host enqueueing a step's layers faster or slower than the card
runs them), per decode step.  The spans go onto the profiler's clock by
the offset of the harness's ``engine_step`` and ``prefill`` spans."""
from bench import program_spans as ps


def read(ctx):
    tr, h = ctx["trace"], ctx["h"]
    spans = ps.kept(h)
    if tr is None or spans is None:
        return None
    off = ps.clock_offset(h, tr, ("engine_step", "prefill"))
    n = ps.steps(spans)
    if off is None or not n:
        return None
    idle = sum((s.end - s.start) / 1e9 - tr.busy_between(s.start + off,
                                                         s.end + off)
               for s in spans if s.name == "engine.decode")
    return 1e3 * idle / n
