"""Packing and dispatch: the program's ``round.pack`` spans (the pool,
``assign_bids``, packing, the K1 launch and the fused K2 launch) in the
traced stretch, per round settled."""
from bench import program_spans as ps


def read(ctx):
    return ps.per_unit_ms(ctx, "round.pack", ps.rounds)
