"""Settle: the program's ``round.settle`` spans (the wait for the scores,
``fixed_point_settle`` and its re-clears through ``core/wis.py``) in the
traced stretch, per round settled."""
from bench import program_spans as ps


def read(ctx):
    return ps.per_unit_ms(ctx, "round.settle", ps.rounds)
