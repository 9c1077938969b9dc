"""Optimizer: the share (%) of the elements that the traced stretch's
``train.optimizer`` spans updated which the update kernel updated: their
``fused_elems`` over their ``elems``."""
from bench import program_spans


def read(ctx):
    spans = program_spans.kept(ctx["h"])
    if spans is None:
        return None
    spans = [s for s in spans if s.name == "train.optimizer"]
    total = sum(s.attrs.get("elems", 0) for s in spans)
    if not total:
        return None
    return 100.0 * sum(s.attrs.get("fused_elems", 0) for s in spans) / total
