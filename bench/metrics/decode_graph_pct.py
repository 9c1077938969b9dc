"""Model step, the decode graph's reach: the share (%) of the program's
``engine.decode`` spans in the traced stretch whose ``graph`` attribute
reads ``replay`` (the step replayed its captured CUDA graph, where
``capture`` and ``eager`` launched the layers from the host).  None where
no span carries the attribute: a program that does not report it."""
from bench import program_spans as ps


def read(ctx):
    spans = ps.kept(ctx["h"])
    if spans is None:
        return None
    how = [s.attrs["graph"] for s in spans
           if s.name == "engine.decode" and "graph" in s.attrs]
    if not how:
        return None
    return 100.0 * how.count("replay") / len(how)
