"""Runtime: the share of the traced stretch of rounds inside the program's
``gc`` spans (pauses of Python's cyclic collector)."""
from bench import program_spans as ps


def read(ctx):
    return ps.share_pct(ctx, "gc")
