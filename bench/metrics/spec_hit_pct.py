"""Round pipeline: the share of the traced stretch's settled rounds whose
preparation was a validated speculation, counted from the ``prep``
attribute of the program's ``round.settle`` spans (``hit`` or
``filtered`` of ``hit``, ``filtered``, ``discarded``, ``serial``)."""
from bench import program_spans as ps


def read(ctx):
    spans = ps.kept(ctx["h"])
    if spans is None:
        return None
    preps = [s.attrs.get("prep") for s in spans if s.name == "round.settle"]
    preps = [p for p in preps if p is not None]
    if not preps:
        return None
    return 100.0 * sum(p in ("hit", "filtered") for p in preps) / len(preps)
