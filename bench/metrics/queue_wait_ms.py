"""Engine: the mean of the program's ``request.queued`` spans (submission
to a claimed slot) of the requests claimed in the traced stretch."""
from bench import program_spans as ps


def read(ctx):
    h = ctx["h"]
    spans = ps.kept(h)
    if spans is None:
        return None
    a, b = h.t_open * 1e9, h.t_close * 1e9
    waits = [s.end - s.start for s in spans
             if s.name == "request.queued" and a <= s.end <= b]
    if not waits:
        return None
    return sum(waits) / len(waits) / 1e6
