"""Bids: the program's ``round.bids`` spans (window announcement and each
agent's bids, ``core/scheduler.py``, ``core/jobs.py``, ``core/negotiation/``)
in the traced stretch, per round settled.  Under the pipeline a round's
speculative bids run inside the round before it; the sum keeps them."""
from bench import program_spans as ps


def read(ctx):
    return ps.per_unit_ms(ctx, "round.bids", ps.rounds)
